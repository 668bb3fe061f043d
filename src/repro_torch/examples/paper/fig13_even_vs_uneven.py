"""Fig. 13: Even vs uneven data distribution (paper: similar time to
stable accuracy)."""
from repro_torch.examples.paper.common import (build_sim, dynamic_target,
                                               emit_curve, emit_tta, run)

TARGET = 0.75


def main(rounds=48, seed=0, device="cuda"):
    even = run(build_sim(table_config=2, policy="all", seed=seed,
                         device=device), mode="sync", rounds=rounds)
    uneven = run(build_sim(table_config=3, policy="all", seed=seed,
                           device=device), mode="sync", rounds=rounds)
    emit_curve("fig13.even", even)
    emit_curve("fig13.uneven", uneven)
    target = dynamic_target(even, uneven, frac=0.9)
    te = emit_tta("fig13.even", even, target)
    tu = emit_tta("fig13.uneven", uneven, target)
    ratio = max(te, tu) / max(min(te, tu), 1e-9)
    print(f"summary,fig13,similar_time_ratio,{ratio:.2f}")
    return {"t_even": te, "t_uneven": tu}


if __name__ == "__main__":
    main()
