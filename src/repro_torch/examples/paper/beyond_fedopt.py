"""Beyond-paper: FedOpt server optimizers vs the paper's plain averaging.

Same fleet/policy as fig17 (Algorithm 2, sync); only the server-side
aggregation rule changes: avg (paper) vs FedAvgM vs FedAdam."""
from repro_torch.core.server_opt import ServerOptimizer
from repro_torch.examples.paper.common import (build_sim, dynamic_target,
                                               emit_tta, run)


def main(rounds=32, seed=0, device="cuda"):
    results = {}
    for method, lr in (("avg", 1.0), ("avgm", 1.0), ("adam", 0.03)):
        sim = build_sim(table_config=2, policy="time_based", seed=seed,
                        device=device)
        sim.server.cfg.server_opt = method
        sim.server._sopt = ServerOptimizer(method, lr=lr)
        sim.server._sopt_state = sim.server._sopt.init(sim.server.params)
        results[method] = run(sim, mode="sync", rounds=rounds)
        print(f"best,beyond_fedopt.{method},{results[method].best_acc:.4f}")
    target = dynamic_target(*results.values(), frac=0.9)
    times = {m: emit_tta(f"beyond_fedopt.{m}", r, target)
             for m, r in results.items()}
    best = min(times, key=times.get)
    print(f"summary,beyond_fedopt,fastest_server_opt,{best}")
    return times


if __name__ == "__main__":
    main()
