"""Self-speculative decode in the port (DESIGN.md §11): the draft-depth
rules, ``sme_apply`` under ``use_spec_depth`` on v3 operands against the
reference (its Pallas kernel in interpret mode, relative 5e-5 of the
output's max, the DESIGN.md §5 bound) and the top-planes oracle, and the
engine: tokens with spec equal tokens without, the cache rows a request
wrote are bitwise those of the run without spec, the spec counters add
up, and sampled rows never speculate."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as RB
from repro.core.integrate import pack_sme_param as ref_pack
from repro_torch.core import backend as B
from repro_torch.core.integrate import to_torch
from repro_torch.serve import Request, ServeEngine

from _torch_small import small_models

TOL = 5e-5


def _pruned(rng, k, n, frac=0.9):
    w = rng.normal(0, 0.05, (k, n))
    w[np.abs(w) < np.quantile(np.abs(w), frac)] = 0.0
    return w


@pytest.fixture(scope="module")
def layer():
    """One pruned 256x256 weight packed for v1, v2 and v3 by the
    reference, on both sides, and an input row."""
    rng = np.random.default_rng(0)
    raw = ref_pack(_pruned(rng, 256, 256), squeeze=1, squeeze_max=7,
                   backend="all")
    x = rng.normal(0, 1, (1, 256)).astype(np.float32)
    return dict(ref={k: jnp.asarray(v) for k, v in raw.items()},
                port=to_torch(raw, "cpu"), x=x, xt=torch.as_tensor(x),
                smew=RB.smeweight_from_param(raw))


DEPTH_CASES = [  # (param, plane_depth, context depth)
    (None, None, None), ({}, 3, None), ({}, "plan", None),
    ({"sme_draft_planes": np.int32(4)}, "plan", None),
    ({"sme_draft_planes": np.zeros((), np.int32)}, "plan", None),
    ({"sme_draft_planes": np.array([0, 2], np.int32)}, "plan", None),
    ({}, None, 5), ({}, 2, 5), ({"sme_draft_planes": np.int32(3)}, None,
                                "plan"),
    ({}, "bogus", None), ({}, None, "bogus")]


@pytest.mark.parametrize("param,depth,ctx", DEPTH_CASES)
def test_resolve_spec_depth_matches_reference(param, depth, ctx):
    def run(mod, p):
        with mod.use_spec_depth(ctx):
            try:
                got = mod.resolve_spec_depth(p, depth)
            except ValueError as e:
                return ("raises", "plan" in str(e))
        return None if got is None else np.asarray(got).tolist()
    port_param = None if param is None else to_torch(param, "cpu")
    assert run(B, port_param) == run(RB, param)


def test_spec_depth_context_is_scoped():
    with B.use_spec_depth(5):
        assert B.resolve_spec_depth({}) == 5
        assert B.resolve_spec_depth({}, 2) == 2      # explicit arg wins
    assert B.resolve_spec_depth({}) is None


def test_draft_matches_reference_and_topk_oracle(layer):
    with B.use_spec_depth(2):
        y = B.sme_apply(layer["xt"], layer["port"], "v3")
    with RB.use_spec_depth(2):
        ref = np.asarray(RB.sme_apply(jnp.asarray(layer["x"]), layer["ref"],
                                      "v3"))
    got = y.numpy()
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()
    oracle = layer["x"].astype(np.float64) @ \
        layer["smew"].dequant_topk_planes(2)
    assert np.abs(got - oracle).max() <= TOL * np.abs(oracle).max()
    full = B.sme_apply(layer["xt"], layer["port"], "v3")
    assert not torch.equal(y, full), "depth 2 must truncate this layer"
    # "plan" reads the param's sme_draft_planes; absent: full precision
    with B.use_spec_depth("plan"):
        assert torch.equal(B.sme_apply(layer["xt"], layer["port"], "v3"),
                           full)
        pm = dict(layer["port"], sme_draft_planes=torch.tensor(2))
        assert torch.equal(B.sme_apply(layer["xt"], pm, "v3"), y)


def test_saturating_depth_is_the_full_product(layer):
    full = B.sme_apply(layer["xt"], layer["port"], "v3")
    deepest = int(layer["smew"].plane_occupancy().sum(axis=0).max())
    for d in (deepest, deepest + 3):
        assert torch.equal(B.sme_apply(layer["xt"], layer["port"], "v3",
                                       plane_depth=d), full)


@pytest.mark.parametrize("name", ["torch", "v1", "v2"])
def test_backends_without_planes_ignore_depth(layer, name):
    full = B.sme_apply(layer["xt"], layer["port"], name)
    assert torch.equal(B.sme_apply(layer["xt"], layer["port"], name,
                                   plane_depth=1), full)


def test_draft_forces_decode_kernel_up_to_one_m_tile(layer, monkeypatch):
    """At 64 < M <= 128 a full-precision call takes the prefill kernel
    and a draft the decode kernel; above 128 the draft is exact."""
    calls = []
    real = B._v3_decode_impl

    def spy(*a, **kw):
        calls.append(kw["plane_depth"])
        return real(*a, **kw)
    monkeypatch.setattr(B, "_v3_decode_impl", spy)
    x = torch.as_tensor(np.random.default_rng(1).normal(0, 1, (96, 256)),
                        dtype=torch.float32)
    full = B.sme_apply(x, layer["port"], "v3")
    assert calls == []
    draft = B.sme_apply(x, layer["port"], "v3", plane_depth=2)
    assert calls == [2] and not torch.equal(draft, full)
    big = torch.cat([x, x])
    assert torch.equal(B.sme_apply(big, layer["port"], "v3", plane_depth=2),
                       B.sme_apply(big, layer["port"], "v3"))
    assert calls == [2]


# ----------------------------------------------------------------- engine
@pytest.fixture(scope="module")
def m():
    return small_models(backend="all")


def _reqs(spec=(True, True, True), temps=(0.0, 0.0, 0.0)):
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(0, 256, n), max_new_tokens=k,
                    spec=s, temperature=t)
            for i, (n, k, s, t) in enumerate(zip((5, 7, 6), (5, 7, 4), spec,
                                                 temps))]


def _run(m, reqs, backend="v3", slots=2, **kw):
    eng = ServeEngine(m.port_api, m.port_packed, slots=slots, s_max=32,
                      backend=backend, device="cpu", **kw)
    eng.run(reqs, max_steps=100)
    assert all(r.done for r in reqs)
    return eng


@pytest.mark.parametrize("backend", ["v3", "v2"])
def test_spec_tokens_equal_non_spec(m, backend):
    base = _reqs()
    _run(m, base, backend)
    for depth in (1, 2):
        mixed = _reqs(spec=(True, False, True))
        eng = _run(m, mixed, backend, spec_depth=depth, spec_len=3)
        assert eng._m["spec_rounds"].value > 0
        assert [r.out_tokens for r in mixed] == [r.out_tokens for r in base]


def test_spec_cache_rows_equal_non_spec(m):
    """Every cache position a request wrote ([0, len(prompt) + tokens - 1))
    is bitwise the run without spec's, although the draft wrote its K/V
    in place and some of it was rolled back."""
    engines = []
    for kw in ({}, dict(spec_depth=1, spec_len=3)):
        reqs = _reqs()
        engines.append((_run(m, reqs, slots=3, **kw), reqs))
    (plain, preqs), (spec, sreqs) = engines
    assert spec._m["spec_rolled_back"].value > 0
    for i, (p, s) in enumerate(zip(preqs, sreqs)):
        assert p.out_tokens == s.out_tokens
        n = len(p.prompt) + len(p.out_tokens) - 1
        for a, b in zip(plain.caches, spec.caches):
            for name in a:
                assert torch.equal(a[name][i, :n], b[name][i, :n])


def test_spec_counters_account_for_drafts(m):
    eng = _run(m, _reqs(), slots=3, spec_depth=1, spec_len=3)
    drafted = eng._m["spec_draft_tokens"].value
    assert drafted > 0 and eng._m["spec_rounds"].value > 0
    assert drafted == eng._m["spec_accepted"].value \
        + eng._m["spec_rolled_back"].value
    assert eng._m["spec_verify_steps"].value > 0
    assert eng._m["spec_accept_frac"].count > 0


def test_sampled_rows_never_speculate(m):
    eng = _run(m, _reqs(temps=(2.0, 2.0, 2.0)), slots=3, spec_depth=2,
               spec_len=3)
    assert eng._m["spec_rounds"].value == 0
    assert eng._m["spec_draft_tokens"].value == 0
    # a sampled row beside speculating greedy rows leaves theirs unchanged
    base = _reqs()
    _run(m, base, slots=3)
    mixed = _reqs(temps=(0.0, 0.8, 0.0))
    eng = _run(m, mixed, slots=3, spec_depth=2, spec_len=3)
    assert eng._m["spec_rounds"].value > 0
    assert mixed[0].out_tokens == base[0].out_tokens
    assert mixed[2].out_tokens == base[2].out_tokens


def test_from_reference_carries_draft_planes(m):
    """A reference tree whose weights carry the compiler's stacked
    ``sme_draft_planes`` comes across with each layer's scalar, which
    ``use_spec_depth("plan")`` reads."""
    import copy
    from repro_torch.convert import from_reference
    tree = copy.deepcopy(m.packed)
    mlp = tree["blocks"]["slot0"]["mlp"]
    mlp["wi"]["w"]["sme_draft_planes"] = np.array([2, 0], np.int32)
    params = from_reference(tree, device="cpu")
    x = torch.as_tensor(np.random.default_rng(4).normal(0, 1, (3, 128)),
                        dtype=torch.float32)
    for layer, depth in zip(params["blocks"], (2, None)):
        w = layer["mlp"]["wi"]["w"]
        with B.use_spec_depth("plan"):
            got = B.sme_apply(x, w, "v3")
        assert torch.equal(got, B.sme_apply(x, w, "v3", plane_depth=depth))
    assert not torch.equal(
        B.sme_apply(x, params["blocks"][0]["mlp"]["wi"]["w"], "v3",
                    plane_depth=2),
        B.sme_apply(x, params["blocks"][0]["mlp"]["wi"]["w"], "v3"))


def test_spec_depth_validation(m):
    for bad in (0, "bogus"):
        with pytest.raises(ValueError, match="spec_depth"):
            ServeEngine(m.port_api, m.port_packed, slots=1, s_max=16,
                        backend="v3", device="cpu", spec_depth=bad)
    eng = ServeEngine(m.port_api, m.port_packed, slots=1, s_max=16,
                      device="cpu", spec_depth="auto")
    assert (eng.spec_depth, eng.spec_len) == ("plan", 4)
