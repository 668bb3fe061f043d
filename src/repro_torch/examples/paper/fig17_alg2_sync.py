"""Fig. 17: Algorithm 2 (training-time-based selection, SYNC) vs random vs
sequential.  Paper: Alg. 2 outperforms both in the EARLY phase (only fast
workers selected), sequential wins late (sync waits on stragglers)."""
from repro_torch.examples.paper.common import (build_sim, dynamic_target,
                                               emit_curve, emit_tta, run)

TARGET_EARLY = 0.6
TARGET = 0.8


def main(rounds=48, seed=0, device="cuda"):
    seq = run(build_sim(table_config=1, policy="sequential", seed=seed,
                        device=device), mode="sync", rounds=rounds)
    rnd = run(build_sim(table_config=2, policy="random", seed=seed,
                        random_k=4, device=device), mode="sync", rounds=rounds)
    alg2 = run(build_sim(table_config=2, policy="time_based", seed=seed,
                         device=device), mode="sync", rounds=rounds)
    emit_curve("fig17.sequential", seq)
    emit_curve("fig17.random", rnd)
    emit_curve("fig17.alg2_sync", alg2)
    early = dynamic_target(seq, rnd, alg2, frac=0.6)
    te = {n: emit_tta(f"fig17.{n}", r, early)
          for n, r in (("sequential", seq), ("random", rnd),
                       ("alg2_sync", alg2))}
    print(f"summary,fig17,alg2_fastest_early,"
          f"{te['alg2_sync'] <= min(te['sequential'], te['random'])}")
    return te


if __name__ == "__main__":
    main()
