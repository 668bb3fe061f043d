"""The port's serving path (launch/steps.py, launch/serve_loop.py,
launch/serve.py) on the CPU: continuous batching must reproduce the port's
own solo serving token for token (tests/test_serve_loop.py's setting), slots
must be recycled, and the entry point must run.  Cross-framework greedy
token identity is not a target (ROADMAP queue 3); per-step logits are, in
test_torch_lm.py.  No JAX here, except the import check of the new
modules."""
import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import threefry
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.launch.serve_loop import Request, ServeLoop
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import build_model

ROOT = Path(__file__).resolve().parents[1]


def solo_generate(model, params, prompt, max_new):
    """Serve one request alone through prefill + decode."""
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    nxt, cache = prefill(params, {"tokens": torch.as_tensor(
        np.asarray(prompt, np.int32)[None])})
    out = [int(nxt[0])]
    pos = len(prompt)
    while len(out) < max_new:
        nxt, cache = decode(params, {
            "tokens": nxt[:, None],
            "positions": torch.full((1, 1), pos, dtype=torch.int32)}, cache)
        out.append(int(nxt[0]))
        pos += 1
    return out


def _model(arch, seed, spec=None):
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    params = model.init(threefry.key(seed), "cpu")
    if spec:
        import dataclasses
        model = build_model(dataclasses.replace(cfg, cache_spec=spec))
    return model, params


@pytest.mark.parametrize("arch,spec", [("granite-20b", None),
                                       ("chatglm3-6b", None),
                                       ("granite-20b", "ring:4/int8")])
def test_continuous_batching_matches_solo(arch, spec):
    model, params = _model(arch, 0, spec)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.cfg.vocab_size, n).astype(np.int32)
               for n in (12, 7, 19)]
    want = [solo_generate(model, params, p, 6) for p in prompts]

    loop = ServeLoop(model, params, max_batch=2, max_len=128)
    for i, p in enumerate(prompts):
        loop.submit(Request(rid=i, prompt=p, max_new=6))  # 3rd joins late
    done = loop.run_until_drained()
    assert len(done) == 3
    got = {r.rid: r.out for r in done}
    for i in range(3):
        assert got[i] == want[i], (i, got[i], want[i])


def test_slots_recycled_and_queue_drains():
    model, params = _model("granite-20b", 1)
    loop = ServeLoop(model, params, max_batch=2, max_len=64)
    rng = np.random.default_rng(1)
    for i in range(5):
        loop.submit(Request(rid=i, prompt=rng.integers(
            0, model.cfg.vocab_size, 8).astype(np.int32), max_new=3))
    done = loop.run_until_drained()
    assert sorted(r.rid for r in done) == [0, 1, 2, 3, 4]
    assert all(len(r.out) == 3 and r.done for r in done)
    assert sorted(loop.free) == [0, 1] and not loop.live
    assert loop.lengths.dtype == np.int32


def test_cache_spec_override_rebuilds_model():
    model, params = _model("granite-20b", 2)
    loop = ServeLoop(model, params, max_batch=2, max_len=32,
                     cache_spec="head/int8")
    assert loop.model.cfg.cache_spec == "head/int8"
    assert loop.cache["k"].dtype == torch.int8 and "k_scale" in loop.cache
    assert loop.cache["k"].shape == (model.cfg.num_layers, 2, 32, 1, 16)


@pytest.mark.parametrize("argv", [[], ["--cache", "head/int8", "--gen", "4"],
                                  ["--arch", "minitron-8b", "--batch", "2",
                                   "--prompt-len", "9", "--gen", "3"],
                                  ["--arch", "phi-3-vision-4.2b", "--batch",
                                   "2", "--prompt-len", "13", "--gen", "3"],
                                  ["--arch", "seamless-m4t-large-v2",
                                   "--batch", "2", "--prompt-len", "9",
                                   "--gen", "3"]])
def test_serve_main_runs_on_cpu(argv, capsys):
    res = serve.main(["--device", "cpu", *argv])
    gen = int(argv[argv.index("--gen") + 1]) if "--gen" in argv else 32
    batch = int(argv[argv.index("--batch") + 1]) if "--batch" in argv else 4
    assert res["tokens"].shape == (batch, gen)
    # CPU: the plain versions, no kernel launched in prefill or decode
    assert res["launches"]["prefill"]["flash_attention"] == 0
    assert all(n == 0 for phase in res["launches"].values()
               for n in phase.values())
    out = capsys.readouterr().out
    assert "[serve] prefill" in out and "ms/step" in out


def test_serve_main_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main([])


NEW_MODULES = ["configs/granite_20b.py", "configs/chatglm3_6b.py",
               "configs/qwen1_5_4b.py", "configs/minitron_8b.py",
               "models/cache.py", "models/layers.py", "models/transformer.py",
               "launch/serve.py", "launch/serve_loop.py",
               "launch/steps.py", "launch/loadgen.py", "core/paging.py",
               "models/model_factory.py", "examples/serve_load.py",
               "examples/serve_batched.py", "examples/profile_serve.py",
               "examples/parity_gap.py", "models/encdec.py",
               "configs/phi_3_vision_4_2b.py",
               "configs/seamless_m4t_large_v2.py",
               "kernels/flash_attention/kernel.py",
               "kernels/flash_attention/ops.py",
               "kernels/flash_attention/ref.py"]


@pytest.mark.parametrize("rel", NEW_MODULES)
def test_new_modules_import_neither_jax_nor_reference(rel):
    path = ROOT / "src" / "repro_torch" / rel
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    assert tops.isdisjoint({"jax", "jaxlib", "repro", "flax", "optax"}), tops
