# FLight core in PyTorch (port of repro.core; the modules ported so far):
#   aggregation -- FedAvg + weighted/staleness variants (fed_agg kernel),
#                  robust aggregators, mixing matrices
#   selection   -- Algorithm 1 (rmin/rmax), Algorithm 2 (time-based), baselines
#   cost_model  -- Eq. 4 system-parameter time estimation + profiles
#   client      -- local training on private shards
#   server_opt  -- FedOpt server optimizers (avg, avgm, adam, yogi)
#   server      -- versioned aggregation server + policy feedback (Eq. 1-3)
#   events      -- discrete-event sync/async FL engine (paper experiments)
from repro_torch.core import (aggregation, client, cost_model, events,
                              selection, server, server_opt)
