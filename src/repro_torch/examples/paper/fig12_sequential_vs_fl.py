"""Fig. 12: Sequential training vs FL with even data distribution.

Paper claim: FL-even reaches a high accuracy BEFORE sequential (parallel
workers), but sequential eventually reaches the better final accuracy."""
from repro_torch.examples.paper.common import (build_sim, dynamic_target,
                                               emit_curve, emit_tta, run)

TARGET = 0.8


def main(rounds=48, seed=0, device="cuda"):
    seq = run(build_sim(table_config=1, policy="sequential", seed=seed,
                        device=device), mode="sync", rounds=rounds)
    fl = run(build_sim(table_config=2, policy="all", seed=seed,
                       device=device), mode="sync", rounds=rounds)
    emit_curve("fig12.sequential", seq)
    emit_curve("fig12.fl_even", fl)
    target = dynamic_target(seq, fl, frac=0.9)
    t_seq = emit_tta("fig12.sequential", seq, target)
    t_fl = emit_tta("fig12.fl_even", fl, target)
    print(f"summary,fig12,fl_reaches_{TARGET}_first,"
          f"{t_fl < t_seq},{t_fl:.1f},{t_seq:.1f}")
    return {"t_fl": t_fl, "t_seq": t_seq}


if __name__ == "__main__":
    main()
