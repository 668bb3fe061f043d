"""Fig. 15: R-min/R-max selection (init 5,5-ish) vs sequential.

Paper finding: Algorithm 1 is NOT more time-efficient than sequential --
rmin/rmax diverge quickly in early training, flooding the selection with
slow workers.  The policy state is logged to show the divergence."""
from repro_torch.examples.paper.common import (build_sim, dynamic_target,
                                               emit_curve, emit_tta, run)

TARGET = 0.8


def main(rounds=36, seed=0, device="cuda"):
    seq = run(build_sim(table_config=1, policy="sequential", seed=seed,
                        device=device), mode="sync", rounds=rounds)
    sim = build_sim(table_config=2, policy="rmin_rmax", seed=seed,
                    rmin=5, rmax=5, device=device)
    res = run(sim, mode="sync", rounds=rounds)
    emit_curve("fig15.sequential", seq)
    emit_curve("fig15.rminmax", res)
    st = sim.server.policy_state
    print(f"policy,fig15,rmin,{st.rmin:.2f},rmax,{st.rmax:.2f}")
    target = dynamic_target(seq, res, frac=0.9)
    t_seq = emit_tta("fig15.sequential", seq, target)
    t_rmm = emit_tta("fig15.rminmax", res, target)
    diverged = st.rmax / max(st.rmin, 1e-9) > 4.0
    print(f"summary,fig15,rminmax_not_faster,{t_rmm >= t_seq},"
          f"diverged,{diverged}")
    return {"t_seq": t_seq, "t_rmm": t_rmm, "rmin": st.rmin, "rmax": st.rmax}


if __name__ == "__main__":
    main()
