"""The paper's experiment suite (Figs. 12-18, FedOpt, overhead) on the
port: `python -m repro_torch.examples.paper.run`."""
