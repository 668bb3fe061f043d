"""Fig. 14: Random worker selection vs sequential (paper: random reaches the
same accuracy but SLOWER and less stably)."""
import numpy as np

from repro_torch.examples.paper.common import (build_sim, dynamic_target,
                                               emit_curve, emit_tta, run)

TARGET = 0.8


def main(rounds=48, seed=0, device="cuda"):
    seq = run(build_sim(table_config=1, policy="sequential", seed=seed,
                        device=device), mode="sync", rounds=rounds)
    rnd = run(build_sim(table_config=2, policy="random", seed=seed,
                        random_k=4, device=device), mode="sync", rounds=rounds)
    emit_curve("fig14.sequential", seq)
    emit_curve("fig14.random", rnd)
    target = dynamic_target(seq, rnd, frac=0.9)
    t_seq = emit_tta("fig14.sequential", seq, target)
    t_rnd = emit_tta("fig14.random", rnd, target)
    # instability: std of round-over-round accuracy deltas
    acc = np.array([r.acc for r in rnd.records])
    jitter = float(np.std(np.diff(acc)))
    print(f"summary,fig14,random_slower,{t_rnd > t_seq},"
          f"jitter,{jitter:.4f}")
    return {"t_seq": t_seq, "t_rnd": t_rnd}


if __name__ == "__main__":
    main()
