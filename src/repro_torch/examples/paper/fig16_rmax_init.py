"""Fig. 16: R-min/R-max sensitivity to rmax initialisation.

Paper finding: with rmax initialised to 5/6/7 (and data concentrated on
slow workers -- uneven config), accuracy STALLS far below the achievable
level, because only fast data-poor workers ever get selected."""
from repro_torch.examples.paper.common import build_sim, emit_curve, run


def main(rounds=20, seed=0, device="cuda"):
    out = {}
    for rmax in (5, 6, 7):
        sim = build_sim(table_config=3, policy="rmin_rmax", seed=seed,
                        rmin=2, rmax=rmax, invert_speed_data=True,
                        speed_spread=8.0, device=device)
        res = run(sim, mode="sync", rounds=rounds)
        emit_curve(f"fig16.rmax{rmax}", res, stride=2)
        out[rmax] = res.best_acc
        print(f"best,fig16.rmax{rmax},{res.best_acc:.4f}")
    ref = run(build_sim(table_config=3, policy="all", seed=seed,
                        invert_speed_data=True, speed_spread=8.0,
                        device=device), mode="sync", rounds=rounds)
    print(f"best,fig16.all_workers,{ref.best_acc:.4f}")
    stalled = all(a < 0.9 * ref.best_acc for a in out.values())
    print(f"summary,fig16,bad_init_stalls_below_achievable,{stalled}")
    return {"rmax_best": out, "ref_best": ref.best_acc}


if __name__ == "__main__":
    main()
