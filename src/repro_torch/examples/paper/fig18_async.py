"""Fig. 18: Algorithm 2 sync vs ASYNC vs sequential -- the paper's headline
results:

  * worker selection cuts time-to-80%-accuracy by ~34% vs sequential;
  * async improves on sync training time by ~64%.

The same two ratios are reported for the reproduction fleet."""
from repro_torch.examples.paper.common import (build_sim, dynamic_target,
                                               emit_curve, emit_tta, run)

TARGET = 0.8


def main(rounds=48, merges=320, seed=0, device="cuda"):
    seq = run(build_sim(table_config=1, policy="sequential", seed=seed,
                        device=device), mode="sync", rounds=rounds,
              target=0.99)
    sync = run(build_sim(table_config=2, policy="time_based", seed=seed,
                         device=device), mode="sync", rounds=rounds,
               target=0.99)
    asyn = run(build_sim(table_config=2, policy="time_based", mode="async",
                         seed=seed, device=device), mode="async",
               merges=merges, target=0.99)
    emit_curve("fig18.sequential", seq)
    emit_curve("fig18.alg2_sync", sync)
    emit_curve("fig18.alg2_async", asyn, stride=2)
    target = dynamic_target(seq, sync, asyn)
    t_seq = emit_tta("fig18.sequential", seq, target)
    t_sync = emit_tta("fig18.alg2_sync", sync, target)
    t_asyn = emit_tta("fig18.alg2_async", asyn, target)
    sel_gain = 1.0 - min(t_sync, t_asyn) / t_seq if t_seq > 0 else 0.0
    async_gain = 1.0 - t_asyn / t_sync if t_sync > 0 else 0.0
    print(f"summary,fig18,selection_vs_sequential_gain,{sel_gain:.2%},"
          f"paper,34%")
    print(f"summary,fig18,async_vs_sync_gain,{async_gain:.2%},paper,64%")
    return {"t_seq": t_seq, "t_sync": t_sync, "t_async": t_asyn,
            "selection_gain": sel_gain, "async_gain": async_gain}


if __name__ == "__main__":
    main()
