"""Serving parity of the port: ``ServeEngine`` tokens equal the reference
model API's greedy loop (the reference ``ServeEngine`` is red under the
installed jax, ROADMAP R1) under each kernel backend (v3, v2, v1 and
``auto``, which resolves to v2 as in the reference), ragged batches equal
solo runs inside the port, and the launcher runs on the CPU."""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import ARCHS as REF_ARCHS, scale_down as ref_scale_down
from repro.core.backend import use_backend
from repro.core.integrate import convert_params_to_sme as ref_convert
from repro.models import build_model as ref_build_model
from repro_torch.configs import ARCHS, scale_down
from repro_torch.convert import from_reference
from repro_torch.models.model import build_model
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.engine import _prompt_bucket

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(d_model=128, d_ff=256, head_dim=32, n_heads=4, n_kv_heads=4,
             vocab=256, n_layers=2, dtype="float32")
#: 3 prompts share a bucket of 64: prefill M = 192 runs the prefill
#: kernel's path, decode M = 3 the decode kernel's
LENS = (33, 20, 9)
MAX_NEW = 4
S_MAX = 96


@pytest.fixture(scope="module")
def setup():
    cfg = ref_scale_down(REF_ARCHS["qwen1.5-0.5b"], **SMALL)
    api = ref_build_model(cfg)
    dense = jax.tree.map(np.asarray, api.init_params(jax.random.key(1)))
    dense["embed"]["w"] = dense["embed"]["w"] * np.float32(0.05)
    packed = ref_convert(dense, squeeze=1, backend="all")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, n) for n in LENS]
    # the reference model-API greedy loop: one ragged prefill, then
    # per-row decode steps, under each kernel backend
    toks = np.zeros((len(prompts), _prompt_bucket(max(LENS), S_MAX)), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    plen = np.array(LENS, np.int32)
    ref_tokens = {}
    for backend in ("v3", "v2", "v1"):
        with use_backend(backend):
            logits, caches = api.prefill(
                packed, {"tokens": jnp.asarray(toks)}, s_max=S_MAX,
                plen=jnp.asarray(plen))
            out = [np.asarray(logits).argmax(-1)]
            for step in range(MAX_NEW - 1):
                logits, caches = api.decode_step(
                    packed, jnp.asarray(out[-1][:, None]), caches,
                    jnp.asarray(plen + step))
                out.append(np.asarray(logits).argmax(-1))
        ref_tokens[backend] = np.stack(out, 1).tolist()
    port_api = build_model(scale_down(ARCHS["qwen1.5-0.5b"], **SMALL),
                           device="cpu")
    return dict(prompts=prompts, ref_tokens=ref_tokens["v3"],
                ref_by_backend=ref_tokens, api=port_api,
                params=from_reference(jax.tree.map(np.asarray, packed),
                                      device="cpu"))


def _serve(setup, prompts, slots, backend="v3"):
    # chunk_len >= every prompt: the one-shot prefill the reference loop
    # runs (the engine's default, 32, would chunk the 33-token prompt)
    eng = ServeEngine(setup["api"], setup["params"], slots=slots,
                      s_max=S_MAX, backend=backend, device="cpu",
                      chunk_len=S_MAX)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(prompts)]
    stats = eng.run(reqs, max_steps=50)
    return [r.out_tokens for r in reqs], stats


def test_engine_tokens_match_reference_greedy_loop(setup):
    tokens, stats = _serve(setup, setup["prompts"], slots=3)
    assert stats["completed"] == 3 and stats["prefills"] == 1
    assert stats["decode_steps"] == MAX_NEW - 1
    assert tokens == setup["ref_tokens"]


@pytest.mark.parametrize("backend,resolved,ref",
                         [("auto", "v2", "v2"), (None, "v2", "v2"),
                          ("v2", "v2", "v2"), ("v1", "v1", "v1")])
def test_engine_tokens_match_reference_under_backend(setup, backend,
                                                     resolved, ref):
    """``auto`` (and None) resolve to v2 among the three packed operand
    sets, as the reference's auto does; every backend serves the
    reference's tokens under the same backend, and all agree with v3."""
    tokens, stats = _serve(setup, setup["prompts"], slots=3, backend=backend)
    assert stats["backend"] == resolved
    assert tokens == setup["ref_by_backend"][ref] == setup["ref_tokens"]


def test_engine_names_dense_and_rejects_unknown_backends(setup):
    dense = {k: v for k, v in setup["params"].items() if k != "blocks"}
    eng = ServeEngine(setup["api"], dense, slots=1, s_max=S_MAX,
                      device="cpu")
    assert eng.stats["backend"] == "dense"
    with pytest.raises(KeyError, match="unknown SME backend"):
        ServeEngine(setup["api"], setup["params"], slots=1, s_max=S_MAX,
                    backend="xla", device="cpu")


def test_ragged_equals_solo(setup):
    ragged, _ = _serve(setup, setup["prompts"], slots=3)
    solo = [_serve(setup, [p], slots=1)[0][0] for p in setup["prompts"]]
    assert ragged == solo
    # fewer slots than requests: later admission windows reuse freed rows
    queued, stats = _serve(setup, setup["prompts"], slots=2)
    assert queued == solo and stats["prefills"] == 2


def test_overlong_prompt_rejected_rest_served(setup):
    prompts = [setup["prompts"][0], np.zeros(S_MAX, np.int64),
               setup["prompts"][2]]
    tokens, stats = _serve(setup, prompts, slots=3)
    assert (stats["completed"], stats["rejected"]) == (2, 1)
    assert tokens[1] == [] and tokens[0] == setup["ref_tokens"][0]


def test_prompt_bucket():
    assert [_prompt_bucket(n, 96) for n in (1, 8, 9, 33, 64, 65, 95)] == \
        [8, 8, 16, 64, 64, 96, 96]


def test_launcher_runs_on_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--small",
         "--device", "cpu", "--sme", "--backend", "v3", "--requests", "3",
         "--max-new", "3", "--slots", "2", "--s-max", "32"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "'completed': 3" in proc.stdout
    assert "SME backend v3" in proc.stdout


@pytest.mark.parametrize("backend,resolved", [("v1", "v1"), ("v2", "v2"),
                                              ("auto", "torch")])
def test_launcher_serves_each_backend_on_cpu(backend, resolved):
    """``--backend v1``/``v2`` emit and serve their operands; ``auto`` on
    the CPU emits none and serves the dense dequant, as the reference
    does off its chip."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--small",
         "--device", "cpu", "--sme", "--backend", backend, "--requests", "2",
         "--max-new", "2", "--slots", "2", "--s-max", "32"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "'completed': 2" in proc.stdout
    assert f"'backend': '{resolved}'" in proc.stdout
    assert "SME storage: {'packed_bytes'" in proc.stdout
