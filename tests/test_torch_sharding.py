"""The port's sharding rules against the reference's, with no ranks.

``repro_torch.parallel.sharding`` against ``repro.parallel.sharding``: for
every ``ARCHS`` entry's small tree in the reference's layout (dense, and
SME-packed with v1, v2 and v3 operands), the meshes (1,1), (2,2), (4,1),
(1,4) and (2,4) as ``jax.sharding.AbstractMesh`` (no devices needed) and
both postures with ``fsdp``/``tp`` on and off, the port's spec of every
leaf equals the reference's ``PartitionSpec`` as a tuple; the same for
the cache rules at batch 1, 2 and 4 and for ``batch_sharding``.  The
port's per-layer trees get their stacked leaf's spec without the stacked
dim.  ``place_tree``'s shards, one per mesh coordinate, reassemble to
every leaf bitwise (deepseek's and llava's at widths where ``kv_up`` and
``patch_proj`` split into whole column tiles); the four kernels' plain
versions on a weight cut into two shards of whole column tiles (qwen's
1024x2816, 22 tiles) give the whole weight's columns bitwise at M = 8
and 512; and MLA's decode on each rank's slot rows, with ``kv_up``
gathered whole, gives the whole decode's output and cache rows bitwise
(the ranks are threads of this process whose stand-in mesh gathers
between them).
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCHS as REF_ARCHS, scale_down as ref_scale_down
from repro.core.integrate import convert_params_to_sme as ref_convert
from repro.models import build_model as ref_build_model
from repro.parallel import sharding as ref_sh
from repro_torch.configs import ARCHS, scale_down
from repro_torch.convert import from_reference, to_reference
from repro_torch.launch.mesh import Mesh, make_serve_mesh, parse_mesh
from repro_torch.models.model import build_model, init_params
from repro_torch.parallel import sharding as sh

from _torch_threads import on_threads as _on_threads

MESHES = [(1, 1), (2, 2), (4, 1), (1, 4), (2, 4)]


#: widths at which deepseek's ``kv_up`` (128 x 4 (64 + 64): 4 column
#: tiles) and llava's ``patch_proj`` (512 x 512: 4 tiles) pack and split
WIDE = {"deepseek-v2-lite-16b": dict(kv_lora=128, rope_head_dim=32,
                                     nope_head_dim=64, v_head_dim=64),
        "llava-next-34b": dict(d_model=512)}


def _over(arch, wide=False):
    """The reference's SME-eligible small size per arch (128 wide); with
    ``wide``, :data:`WIDE`'s widths on top."""
    over = dict(d_model=128, d_ff=256, vocab=256, dtype="float32")
    if arch == "whisper-medium":
        over["n_layers"] = 2
    if arch in ("mixtral-8x7b", "deepseek-v2-lite-16b", "jamba-v0.1-52b"):
        over["expert_dff"] = 128
    return {**over, **WIDE[arch]} if wide else over


@functools.lru_cache(maxsize=None)
def _trees(arch, wide=False):
    """(reference config, dense abstract tree, packed numpy tree): the
    packed one is the port's numpy init in the reference's layout, packed
    by the reference's converter with every operand set."""
    cfg = ref_scale_down(REF_ARCHS[arch], **_over(arch, wide))
    dense = jax.eval_shape(ref_build_model(cfg).init_params,
                           jax.random.key(0))
    pcfg = scale_down(ARCHS[arch], **_over(arch, wide))
    ref = to_reference(init_params(pcfg, np.random.default_rng(0)),
                       len(pcfg.pattern)) if not pcfg.n_enc_layers else \
        to_reference(init_params(pcfg, np.random.default_rng(0)))
    packed = ref_convert(ref, squeeze=1, backend="all")
    return cfg, dense, jax.tree.map(np.asarray, packed)


def _ref_specs(tree):
    return {jax.tree_util.keystr(p): tuple(s.spec) for p, s in
            jax.tree_util.tree_leaves_with_path(tree)}


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (i,))
    else:
        yield path, tree


def _specs(tree, specs):
    """{path: spec} of a spec tree, read along its input ``tree`` (a spec
    is a tuple, so the input says which tuples are containers)."""
    out = {}
    for path, _ in _flat(tree):
        spec = specs
        for k in path:
            spec = spec[k]
        out[_keystr(path)] = spec
    return out


def _keystr(path):
    return "".join(f"[{k}]" if isinstance(k, int) else f"['{k}']"
                   for k in path)


@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_param_specs_match_reference(arch):
    _, dense, packed = _trees(arch)
    n = 0
    for tree in (dense, packed):
        for shape in MESHES:
            mesh = AbstractMesh(shape, ("data", "model"))
            for exact in (False, True):
                for fsdp in (True, False):
                    for tp in (True, False):
                        want = _ref_specs(ref_sh.param_sharding(
                            mesh, tree, fsdp=fsdp, tp=tp, exact=exact))
                        got = _specs(tree, sh.param_sharding(
                            mesh, tree, fsdp=fsdp, tp=tp, exact=exact,
                            port=False))
                        assert got == want, (shape, exact, fsdp, tp)
                        n += len(want)
            for path, leaf in _flat(tree):
                key = "/".join(map(str, path))
                assert sh.leaf_sharding(mesh, key, leaf.shape) == tuple(
                    ref_sh.leaf_sharding(mesh, key, leaf.shape).spec), key
    assert n > 0
    assert sh.EXACT_MIN_SHARD == ref_sh.EXACT_MIN_SHARD


@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_port_layout_specs_drop_the_stacked_dim(arch):
    """A per-layer port leaf's spec is its stacked reference leaf's without
    the superblock dim (``blocks/i`` is slot ``i % n_slots``)."""
    cfg, _, packed = _trees(arch)
    port = from_reference(packed, device="cpu")
    n_slots = len(cfg.pattern)
    for shape in MESHES[1:]:
        mesh = AbstractMesh(shape, ("data", "model"))
        for exact in (False, True):
            want = _ref_specs(ref_sh.param_sharding(mesh, packed,
                                                    exact=exact))
            got = _specs(port, sh.param_sharding(mesh, port, exact=exact))
            for path, _ in _flat(port):
                spec = got[_keystr(path)]
                if path[0] in ("blocks", "enc", "dec"):
                    head = (("blocks", f"slot{path[1] % n_slots}")
                            if path[0] == "blocks" else (path[0],))
                    assert spec == want[_keystr(head + path[2:])][1:], path
                else:
                    assert spec == want[_keystr(path)], path


@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_cache_specs_match_reference(arch):
    cfg, _, _ = _trees(arch)
    api = ref_build_model(cfg)
    for batch in (1, 2, 4):
        acache = api.abstract_cache(batch=batch, s_max=32)
        for shape in MESHES:
            mesh = AbstractMesh(shape, ("data", "model"))
            for exact in (False, True):
                want = _ref_specs(ref_sh.cache_sharding(mesh, acache, batch,
                                                        exact=exact))
                got = _specs(acache, sh.cache_sharding(
                    mesh, acache, batch, exact=exact, port=False))
                assert got == want, (batch, shape, exact)


def test_port_cache_specs_and_batch_sharding():
    """The engine's per-layer caches get their stacked leaf's spec without
    the superblock dim; ``batch_sharding`` is the reference's."""
    cfg = ref_scale_down(REF_ARCHS["gemma3-12b"], **_over("gemma3-12b"))
    papi = build_model(scale_down(ARCHS["gemma3-12b"], **_over(
        "gemma3-12b")), device="cpu")
    n_slots = len(cfg.pattern)
    for batch in (1, 2, 4):
        acache = ref_build_model(cfg).abstract_cache(batch=batch, s_max=32)
        port = papi.init_cache(batch, 32, device="meta")
        for shape in MESHES:
            mesh = AbstractMesh(shape, ("data", "model"))
            want = _ref_specs(ref_sh.cache_sharding(mesh, acache, batch,
                                                    exact=True))
            got = _specs(port, sh.cache_sharding(mesh, port, batch,
                                                 exact=True))
            for path, _ in _flat(port):
                key = _keystr(("blocks", f"slot{path[0] % n_slots}")
                              + path[1:])
                assert got[_keystr(path)] == want[key][1:], (path, shape)
    for b in (1, 2, 3, 4, 8):
        batch = {"tokens": jax.ShapeDtypeStruct((b, 16), np.int32),
                 "mask": jax.ShapeDtypeStruct((b, 16, 2), np.float32)}
        for shape in MESHES:
            mesh = AbstractMesh(shape, ("data", "model"))
            for inc in (False, True):
                want = _ref_specs(ref_sh.batch_sharding(mesh, batch, inc))
                got = _specs(batch, sh.batch_sharding(mesh, batch, inc))
                assert got == want, (b, shape, inc)


#: the recurrent archs 256 wide and two superblocks deep (mLSTM's dv 128
#: and Mamba's d_in 512 split at 'model' 2; the stacked dim is 2)
RECURRENT_WIDE = {
    "jamba-v0.1-52b": dict(d_model=256, d_ff=256, vocab=256, expert_dff=128,
                           n_layers=16, dtype="float32"),
    "xlstm-1.3b": dict(d_model=256, d_ff=0, vocab=256, n_layers=16,
                       dtype="float32")}
#: the reference's tuple states, in its order (the port names them)
STATE_NAMES = {"mlstm": ("C", "n", "m"), "slstm": ("c", "n", "h", "m")}


@pytest.mark.parametrize("arch", sorted(RECURRENT_WIDE))
def test_recurrent_cache_specs_follow_reference_and_r11(arch):
    """A recurrent layer's per-layer state specs (``sharding.state_spec``,
    keyed on the layer's kind) equal the reference's stacked spec without
    the superblock dim wherever the reference puts the slot rows over
    'data' (Mamba's ``conv``/``h``, mLSTM's ``C``/``n``); elsewhere
    (mLSTM's ``m``, sLSTM's states) they follow ROADMAP R11: the slot rows
    over 'data' where they divide, every other dim whole.  Attention
    layers keep the stacked rule."""
    over = RECURRENT_WIDE[arch]
    cfg = ref_scale_down(REF_ARCHS[arch], **over)
    papi = build_model(scale_down(ARCHS[arch], **over), device="cpu")
    kinds = list(papi.cfg.pattern)
    n_slots = len(kinds)
    seen = {"reference": 0, "R11": 0}
    for batch in (1, 2, 4):
        acache = ref_build_model(cfg).abstract_cache(batch=batch, s_max=32)
        port = papi.init_cache(batch, 32, device="meta")
        for shape in MESHES:
            mesh = AbstractMesh(shape, ("data", "model"))
            want = _ref_specs(ref_sh.cache_sharding(mesh, acache, batch,
                                                    exact=True))
            got = _specs(port, sh.cache_sharding(mesh, port, batch,
                                                 exact=True))
            rows = "data" if batch % shape[0] == 0 else None
            for path, leaf in _flat(port):
                kind = kinds[path[0] % n_slots]
                name = path[-1]
                whole = kind == "slstm" or (kind, name) == ("mlstm", "m")
                if kind in STATE_NAMES:
                    name = STATE_NAMES[kind].index(name)
                key = _keystr(("blocks", f"slot{path[0] % n_slots}", name))
                ref = want[key]
                spec = got[_keystr(path)]
                if ref[1] == "data" or not whole:
                    assert spec == ref[1:], (path, shape, batch, ref)
                    seen["reference"] += ref[1] == "data"
                else:
                    assert spec == (rows,) + (None,) * (leaf.dim() - 1), \
                        (path, shape, batch, spec)
                    seen["R11"] += 1
    assert seen["reference"] > 0
    assert seen["R11"] > 0 or arch == "jamba-v0.1-52b"


def test_reference_stacked_state_rule_puts_rows_over_model():
    """What the reference's exact rule gives its stacked [L, B, NH] (mLSTM's
    ``m``) and [L, B, D] (sLSTM's states) on (2, 2) at batch 4: the
    superblock dim over 'data' and the slot rows over 'model' (ROADMAP
    R11), while its [L, B, NH, dh] and [L, B, NH, dh, dv] put the rows
    over 'data'."""
    S = jax.ShapeDtypeStruct
    tree = {"blocks": {
        "slot0": (S((2, 4, 4, 128, 128), np.float32),
                  S((2, 4, 4, 128), np.float32), S((2, 4, 4), np.float32)),
        "slot7": tuple(S((2, 4, 256), np.float32) for _ in range(4))}}
    mesh = AbstractMesh((2, 2), ("data", "model"))
    got = _ref_specs(ref_sh.cache_sharding(mesh, tree, 4, exact=True))
    assert got["['blocks']['slot0'][0]"] == (None, "data", None, None,
                                             "model")
    assert got["['blocks']['slot0'][1]"] == (None, "data", "model", None)
    assert got["['blocks']['slot0'][2]"] == ("data", "model", None)
    for i in range(4):
        assert got[f"['blocks']['slot7'][{i}]"] == ("data", "model", None)


def test_parse_and_serve_mesh_errors():
    """``parse_mesh``'s messages are the reference's; a mesh that needs
    more ranks than run raises with the launcher's way to get them."""
    from repro.launch.mesh import parse_mesh as ref_parse
    assert parse_mesh("2,2") == ref_parse("2,2") == (2, 2)
    for bad in ("2", "2,2,2", "0,1"):
        with pytest.raises(ValueError) as ours:
            parse_mesh(bad)
        with pytest.raises(ValueError) as theirs:
            ref_parse(bad)
        assert str(ours.value) == str(theirs.value)
    assert make_serve_mesh("1,1", device="cpu").size == 1
    with pytest.raises(ValueError, match="needs 4 ranks but only 1"):
        make_serve_mesh("2,2", device="cpu")
    with pytest.raises(ValueError, match="process groups"):
        Mesh(2, 2, device="cpu")


def _coords(data, model):
    """One stand-in Mesh per coordinate (placement reads only the shape,
    the coordinates and the device; no collective runs here)."""
    return [Mesh(data, model, rank=r, device="cpu", groups={"world": None})
            for r in range(data * model)]


def _join(parts, dim):
    return torch.cat(parts, dim=dim)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mixtral-8x7b",
                                  "deepseek-v2-lite-16b", "llava-next-34b"])
@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (2, 1)])
def test_place_tree_shards_reassemble(arch, shape):
    """Every rank's shards of every leaf (dense and packed) join back into
    the leaf bitwise; split leaves carry their Split, whole ones do not;
    deepseek's packed ``kv_up`` and llava's packed ``patch_proj`` split
    into whole column tiles on every mesh with a 'model' axis."""
    wide = arch in WIDE
    _, _, packed = _trees(arch, wide)
    cfg = scale_down(ARCHS[arch], **_over(arch, wide))
    dense = init_params(cfg, np.random.default_rng(0))
    for tree in (dense, from_reference(packed, device="cpu")):
        full = dict(_flat(tree))
        meshes = _coords(*shape)
        whole_tree = sh.place_tree(tree, meshes[0])
        placed = [dict(_flat(sh.place_tree(tree, m))) for m in meshes]
        model = shape[1]
        if wide and model > 1:
            w = (whole_tree["first0"]["mix"]["kv_up"]["w"] if cfg.kv_lora
                 else whole_tree["patch_proj"]["w"])
            assert sh.split_of(w) is not None and sh.split_of(w).step * \
                model == (cfg.kv_lora and cfg.n_heads * 128 or 512)
        n_split = 0
        for key, leaf in full.items():
            leaf = torch.as_tensor(np.asarray(leaf))
            parts = [p[key] for p in placed]
            # ranks of one model coordinate hold the same shard
            for r, t in enumerate(parts):
                assert torch.equal(t, parts[r % model]), key
            mine = parts[:model]
            if all(t.shape == leaf.shape for t in mine):
                assert torch.equal(mine[0], leaf), key
                continue
            n_split += 1
            dim = next(d for d in range(leaf.dim())
                       if mine[0].shape[d] != leaf.shape[d])
            assert torch.equal(_join(mine, dim), leaf), key
        if model > 1:
            assert n_split > 0, "no leaf split on the model axis"


@functools.lru_cache(maxsize=None)
def _qwen_wi():
    """qwen's wi at full width, 1024x2816 (22 column tiles), packed for
    v1, v2 and v3 from one compression."""
    from repro_torch.core.integrate import convert_params_to_sme
    rng = np.random.default_rng(7)
    w = rng.standard_normal((1024, 2816), dtype=np.float32) * np.float32(
        1 / 32)
    tree = convert_params_to_sme({"wi": {"w": w}}, squeeze=1,
                                 backend="all", device="cpu")
    return tree


@pytest.mark.parametrize("m", [8, 512])
@pytest.mark.parametrize("backend", ["v1", "v2", "v3"])
def test_plain_kernels_on_two_shards_bitwise(backend, m):
    """The plain versions on two shards of 11 whole column tiles each, the
    parts concatenated, equal the whole weight's product bitwise (v3 at M
    = 8 takes the decode kernel, at 512 the prefill kernel)."""
    from repro_torch.core.backend import sme_apply
    tree = _qwen_wi()
    x = torch.as_tensor(np.random.default_rng(m).standard_normal(
        (m, 1024), dtype=np.float32))
    whole = sme_apply(x, tree["wi"]["w"], backend)
    parts = []
    for mesh in _coords(1, 2):
        w = sh.place_tree(tree, mesh)["wi"]["w"]
        assert w[f"sme_{backend}_nnz"].shape[-1] == 11
        assert sh.split_of(w) == sh.Split(-1, 2816, 11 * 128,
                                          mesh.index("model") * 11 * 128)
        parts.append(sme_apply(x, w, backend))
    assert torch.equal(torch.cat(parts, dim=-1), whole)


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_mla_decode_on_row_shards_bitwise(shape, packed):
    """``mla_decode`` on each rank's slot rows of the compressed cache,
    its ``kv_up`` column-split into whole tiles and gathered whole once,
    equals the whole decode bitwise on every rank: the output, and the
    cache rows the rank holds (the new row written only where its slot
    lives, an inactive row left alone)."""
    from repro_torch.core.integrate import to_torch
    from repro_torch.models.attention import mla_decode
    from repro_torch.parallel.policy import policy_for, use_policy
    arch = "deepseek-v2-lite-16b"
    cfg = scale_down(ARCHS[arch], **_over(arch, True))
    tree = from_reference(_trees(arch, True)[2], device="cpu") if packed \
        else to_torch(init_params(cfg, np.random.default_rng(0)), "cpu")
    mix = tree["first0"]["mix"]
    rng = np.random.default_rng(11)
    b, s_len = 4, 16
    x = torch.as_tensor(rng.standard_normal((b, 1, cfg.d_model),
                                            dtype=np.float32))
    cache = {"c": torch.as_tensor(rng.standard_normal(
        (b, s_len, cfg.kv_lora), dtype=np.float32)),
        "k_pe": torch.as_tensor(rng.standard_normal(
            (b, s_len, cfg.rope_head_dim), dtype=np.float32))}
    pos = torch.tensor([5, 9, 3, 12])
    active = torch.tensor([True, True, False, True])
    want = {k: v.clone() for k, v in cache.items()}
    y_want, _ = mla_decode(mix, x, want, pos, cfg, active=active)

    def rank_main(mesh):
        pol = dataclasses.replace(policy_for(mesh, cfg, "decode"),
                                  exact=True)
        p = sh.place_tree(mix, mesh)
        rows = b // shape[0]
        r0 = mesh.index("data") * rows
        mine = {k: v[r0:r0 + rows].clone() for k, v in cache.items()}
        with use_policy(pol):
            y, c = mla_decode(p, x, mine, pos, cfg, active=active)
        return y, c, r0, rows, sh.split_of(p["kv_up"]["w"])
    for y, c, r0, rows, split in _on_threads(shape, rank_main):
        assert (split is not None) == (shape[1] > 1)
        assert torch.equal(y, y_want)
        for k in c:
            assert c[k].shape[0] == rows
            assert torch.equal(c[k], want[k][r0:r0 + rows]), k


#: kind -> (arch, widths, layer): Mamba at the recurrent tests' widths
#: (d_in 256: ``conv``/``h`` split at 'model' 2 and 4), mLSTM and sLSTM
#: 256 wide (``C``'s dv 128 splits at 'model' 2, ``n``'s 4 heads at 2 and
#: 4)
STATE_LAYERS = {
    "mamba": ("jamba-v0.1-52b", dict(d_model=128, d_ff=256, vocab=256,
                                     expert_dff=128, dtype="float32"), 0),
    "mlstm": ("xlstm-1.3b", dict(d_model=256, d_ff=0, vocab=256,
                                 dtype="float32"), 0),
    "slstm": ("xlstm-1.3b", dict(d_model=256, d_ff=0, vocab=256,
                                 dtype="float32"), 7)}


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", sorted(STATE_LAYERS))
def test_recurrent_decode_on_state_shards_bitwise(kind, shape, packed):
    """``mamba_decode``/``mlstm_decode``/``slstm_decode`` on each rank's
    state shard (slot rows over 'data'; Mamba's ``conv``/``h`` d_in,
    mLSTM's ``C`` dv and ``n`` heads over 'model', as
    ``sharding.state_spec`` splits them), their projections column-split
    into whole tiles, equal the whole decode bitwise on every rank: the
    output, and the state block the rank holds (an inactive row left as
    it was); the prefill keeps every row and this rank's channels of the
    whole prefill's state."""
    from repro_torch.core.integrate import convert_params_to_sme, to_torch
    from repro_torch.models.blocks import SSM_KINDS
    from repro_torch.parallel.policy import (policy_for, state_part,
                                             use_policy)
    arch, over, layer = STATE_LAYERS[kind]
    cfg = scale_down(ARCHS[arch], **over)
    tree = init_params(cfg, np.random.default_rng(0))
    mix = tree["blocks"][layer]["mix"]
    mix = convert_params_to_sme(mix, squeeze=1, backend="v2",
                                device="cpu") if packed else \
        to_torch(mix, "cpu")
    apply_fn, decode_fn, init_fn = SSM_KINDS[kind]
    rng = np.random.default_rng(12)
    b = 4
    x = torch.as_tensor(rng.standard_normal((b, 1, cfg.d_model),
                                            dtype=np.float32))
    xs = torch.as_tensor(rng.standard_normal((b, 5, cfg.d_model),
                                             dtype=np.float32))
    plen = np.array([5, 3, 1, 4])
    state = {k: torch.as_tensor(rng.standard_normal(tuple(v.shape),
                                                    dtype=np.float32))
             for k, v in init_fn(cfg, b, torch.float32, "cpu").items()}
    active = torch.tensor([True, False, True, True])
    y_want, s_want = decode_fn(mix, x, state, cfg, active=active)
    yp_want, sp_want = apply_fn(mix, xs, cfg, plen=plen)
    n_split = 0

    def rank_main(mesh):
        pol = dataclasses.replace(policy_for(mesh, cfg, "decode"),
                                  exact=True)
        p = sh.place_tree(mix, mesh)
        with use_policy(pol):
            mine = {k: state_part(v, sh.shard_shape(mesh, sh.state_spec(
                mesh, kind, k, v.shape, b, exact=True), v.shape))
                for k, v in state.items()}
            y, new = decode_fn(p, x, mine, cfg, active=active)
            yp, pre = apply_fn(p, xs, cfg, plen=plen)
            blocks = {k: state_part(s_want[k], mine[k].shape)
                      for k in mine}
            pre_want = {k: state_part(sp_want[k], pre[k].shape)
                        for k in pre}
        return y, yp, new, blocks, pre, pre_want
    for y, yp, new, blocks, pre, pre_want in _on_threads(shape, rank_main):
        assert torch.equal(y, y_want)
        assert torch.equal(yp, yp_want)
        for k in new:
            assert new[k].shape == blocks[k].shape, k
            assert torch.equal(new[k], blocks[k]), k
            assert pre[k].shape[0] == b
            assert torch.equal(pre[k], pre_want[k]), k
            n_split += new[k].shape != state[k].shape
    # sLSTM's states split only their rows
    assert (n_split > 0) == (kind != "slstm" or shape[0] > 1)


#: whisper's cross-attention 512 wide, 16 heads of 32: q and o of 4
#: column tiles, so the packed ones split at 'model' 2 and 4 too
CROSS = dict(d_model=512, d_ff=512, head_dim=32, n_heads=16, n_kv_heads=16,
             vocab=256, n_layers=2, dtype="float32")


@pytest.mark.parametrize("backend", [None, "v2", "v3"],
                         ids=["dense", "v2", "v3"])
@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_cross_decode_on_head_shards_bitwise(shape, backend):
    """``cross_decode`` on each rank's shard of the cross K/V (its slot
    rows over 'data', its heads over 'model', as the cache rule splits
    them), with a ragged ``src_len`` and ``q``/``o`` column-split into
    whole tiles, equals the whole call bitwise on every rank; so does the
    prefill's cross K/V the rank keeps (``constrain(..., "kv")``: its
    heads of the whole ``cross_kv``)."""
    from repro_torch.core.integrate import convert_params_to_sme, to_torch
    from repro_torch.models.attention import cross_decode, cross_kv
    from repro_torch.parallel.policy import (constrain, policy_for,
                                             state_part, use_policy)
    cfg = scale_down(ARCHS["whisper-medium"], **CROSS)
    tree = init_params(cfg, np.random.default_rng(0))
    cross = tree["dec"][0]["cross"]
    cross = to_torch(cross, "cpu") if backend is None else \
        convert_params_to_sme(cross, squeeze=1, backend=("v2", "v3"),
                              device="cpu")
    rng = np.random.default_rng(13)
    b, t, h, hd = 4, 16, cfg.n_heads, cfg.hd
    x = torch.as_tensor(rng.standard_normal((b, 1, cfg.d_model),
                                            dtype=np.float32))
    enc = torch.as_tensor(rng.standard_normal((b, t, cfg.d_model),
                                              dtype=np.float32))
    kv = {k: torch.as_tensor(rng.standard_normal((b, t, h, hd),
                                                 dtype=np.float32))
          for k in "kv"}
    src_len = np.array([5, 16, 9, 1])
    y_want = cross_decode(cross, x, kv, cfg, src_len, backend)
    kv_want = cross_kv(cross, enc, cfg, backend)

    def rank_main(mesh):
        pol = dataclasses.replace(policy_for(mesh, cfg, "decode"),
                                  exact=True)
        p = sh.place_tree(cross, mesh)
        part = (b // mesh.data, t, h // mesh.model, hd)
        with use_policy(pol):
            mine = {k: state_part(v, part) for k, v in kv.items()}
            y = cross_decode(p, x, mine, cfg, src_len, backend)
            kept = {k: constrain(v, "kv", n_kv=h)
                    for k, v in cross_kv(p, enc, cfg, backend).items()}
            want = {k: state_part(v, (b,) + part[1:])
                    for k, v in kv_want.items()}
        return y, kept, want, sh.split_of(p["q"]["w"]), \
            sh.split_of(p["o"]["w"])
    for y, kept, want, sq, so in _on_threads(shape, rank_main):
        assert torch.equal(y, y_want)
        for k in kept:
            assert kept[k].shape == (b, t, h // shape[1], hd)
            assert torch.equal(kept[k], want[k]), k
        assert (sq is not None) == (so is not None) == (shape[1] > 1)


def _slice(leaf, spec, mesh):
    """``leaf`` cut to ``mesh``'s coordinate under ``spec`` (jax's block
    layout: shard ``i`` of ``n`` holds the ``i``-th of ``n`` equal
    blocks)."""
    idx = []
    for dim, ax in zip(leaf.shape, spec):
        if ax is None:
            idx.append(slice(None))
            continue
        n, i = mesh.shape[ax], mesh.index(ax)
        idx.append(slice(i * dim // n, (i + 1) * dim // n))
    return leaf[tuple(idx)]


def _throughput_shards_follow(cfg, shape):
    """``place_throughput`` of ``cfg``'s small tree (2 layers or more, f32)
    and of an AdamW state of it on every coordinate of ``shape`` against
    the reference's ``param_sharding(fsdp=True, exact=False)``, and the
    shards gathered back on rank threads (see the tests below); returns
    {path: spec} of the params."""
    from repro_torch.core.integrate import to_torch
    from repro_torch.optim import adamw
    from _torch_threads import on_threads
    n_slots = len(cfg.pattern)
    params = to_torch(init_params(cfg, np.random.default_rng(0)), "cpu")
    ref = to_reference(params, n_slots)
    want = _ref_specs(ref_sh.param_sharding(
        AbstractMesh(shape, ("data", "model")), ref, fsdp=True,
        exact=False))
    rng = np.random.default_rng(1)
    state = {k: jax.tree.map(lambda t: torch.as_tensor(rng.standard_normal(
        t.shape, dtype=np.float32)), v)
        for k, v in adamw(1e-3).init(params).items()}
    trees = {"params": params, "m": state["m"], "v": state["v"]}
    n_split, specs = 0, {}
    for mesh in _coords(*shape):
        for name, tree in trees.items():
            placed = dict(_flat(sh.place_throughput(tree, mesh)))
            for path, leaf in _flat(tree):
                if path[0] == "blocks":
                    slot = ("blocks", f"slot{path[1] % n_slots}")
                    spec = want[_keystr(slot + path[2:])][1:]
                else:
                    spec = want[_keystr(path)]
                specs[path] = spec
                got = placed[path]
                assert sh.cut_of(got) == sh.Cut(tuple(leaf.shape), spec,
                                                mesh), (name, path)
                assert torch.equal(got, _slice(leaf, spec, mesh)), path
                n_split += got.shape != leaf.shape
        assert all(sh.cut_of(t) is None
                   for _, t in _flat(sh.place_tree(params, mesh)))
    assert n_split > 0

    def gathered(mesh):
        return {name: sh.gather_throughput(sh.place_throughput(tree, mesh),
                                           mesh)
                for name, tree in trees.items()}
    for got in on_threads(shape, gathered):
        for name, tree in trees.items():
            whole = dict(_flat(got[name]))
            for path, leaf in _flat(tree):
                assert sh.cut_of(whole[path]) is None
                assert torch.equal(whole[path], leaf), (name, path)
    return specs


@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 4), (2, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_throughput_shards_follow_reference_spec(shape):
    """``place_throughput`` on qwen's small dense tree and on an AdamW
    state of it (``m`` and ``v``, drawn so that no leaf is zero): every
    rank's shard of every leaf equals the whole leaf sliced by the
    reference's ``_param_spec(fsdp=True, exact=False)`` of its stacked
    leaf (``param_sharding``'s spec, the layer dim dropped), and carries
    its Cut; on rank threads ``gather_throughput`` joins the shards back
    into every leaf bitwise; a packed tree is refused; ``place_tree``'s
    exact shards carry no Cut."""
    cfg = scale_down(ARCHS["qwen1.5-0.5b"], n_layers=2, dtype="float32")
    specs = _throughput_shards_follow(cfg, shape)
    # row-parallel, FSDP
    assert specs[("blocks", 0, "mix", "o", "w")] == ("model", "data")
    with pytest.raises(ValueError, match="wi/w is SME-packed"):
        sh.place_throughput(_qwen_wi(), _coords(*shape)[0])


#: the MoE family and MLA at the CPU tests' size; ``mixtral-e6``'s 6
#: experts divide no 'model' axis of 4 (expert-TP there)
_W128 = dict(d_model=128, expert_dff=128, dtype="float32")
THROUGHPUT_MOE = {
    "mixtral": ("mixtral-8x7b", dict(_W128, n_layers=2)),
    "mixtral-e6": ("mixtral-8x7b", dict(_W128, n_layers=2, n_experts=6)),
    "deepseek": ("deepseek-v2-lite-16b", _W128)}


@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("model", list(THROUGHPUT_MOE))
def test_throughput_moe_mla_shards_follow_reference_spec(model, shape):
    """The same for mixtral's and deepseek's small trees (their AdamW
    state too), and by name: expert stacks expert-parallel where the
    experts divide 'model' (wi/wg ``["model", "data", None]``, wo
    ``["model", None, "data"]``), else expert-TP (``[None, "data",
    "model"]``, wo ``[None, "model", "data"]``); the router whole; the
    shared experts and ``first0``'s MLP column-parallel with ``wo``
    row-parallel; MLA's q, kv_down and kv_up column-parallel, o
    row-parallel; a layer's norms over 'model', ``first0``'s whole."""
    arch, over = THROUGHPUT_MOE[model]
    cfg = scale_down(ARCHS[arch], **over)
    specs = _throughput_shards_follow(cfg, shape)

    def drop(spec):
        """The spec as a mesh of these sizes cuts it."""
        return tuple(None if ax and dict(zip(("data", "model"), shape))[ax]
                     == 1 else ax for ax in spec)
    got = {k: drop(v) for k, v in specs.items()}
    col, row = drop(("data", "model")), drop(("model", "data"))
    tp = cfg.n_experts % shape[1] != 0
    mlp = ("blocks", 0, "mlp")
    assert got[mlp + ("wi",)] == got[mlp + ("wg",)] == drop(
        (None, "data", "model") if tp else ("model", "data", None))
    assert got[mlp + ("wo",)] == drop((None, "model", "data") if tp
                                      else ("model", None, "data"))
    assert got[mlp + ("router", "w")] == (None, None)
    assert got[("blocks", 0, "norm1", "w")] == drop(("model",))
    if model != "deepseek":
        assert got[("blocks", 0, "mix", "q", "w")] == col
        return
    for name in ("wi", "wg"):
        assert got[mlp + ("shared", name, "w")] == col
        assert got[("first0", "mlp", name, "w")] == col
    assert got[mlp + ("shared", "wo", "w")] == row
    assert got[("first0", "mlp", "wo", "w")] == row
    for name in ("q", "kv_down", "kv_up"):
        assert got[("blocks", 0, "mix", name, "w")] == col, name
        assert got[("first0", "mix", name, "w")] == col, name
    assert got[("blocks", 0, "mix", "o", "w")] == row
    assert got[("first0", "norm1", "w")] == (None,)


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_throughput_ops_and_gradients_on_rank_threads(shape):
    """Under the throughput posture, on rank threads: a column-split then
    a row-split ``throughput_linear`` (its bias gathered whole once after
    the reduce), a split norm weight read whole, and the vocab-parallel
    ``chunked_ce_loss`` over a vocab-split head (its chunks recomputed in
    the backward) give the whole computation's loss and every gradient
    within 1e-5: this rank's rows of the input's, its slices of the
    weights' (summed over 'data', whose ranks hold other rows).  The
    backward runs after the policy is left, as a card's autograd thread
    runs it, so nothing in it may read the policy."""
    from repro_torch.models.common import rmsnorm
    from repro_torch.models.transformer import chunked_ce_loss
    from repro_torch.parallel.policy import (ShardPolicy, model_split,
                                             throughput_linear, use_policy)
    from _torch_threads import on_threads
    data, model = shape
    rng = np.random.default_rng(3)
    b, s, k, n, v = 2 * data, 6, 8, 16, 32

    def draw(*dims):
        return torch.as_tensor(rng.standard_normal(dims, dtype=np.float32))
    x, wc, bc, wr, br, g, table = (draw(b, s, k), draw(k, n), draw(n),
                                   draw(n, k), draw(k), draw(k), draw(v, k))
    labels = torch.as_tensor(rng.integers(0, v, (b, s)))
    mask = torch.as_tensor(rng.random((b, s)) < 0.8).float()

    def loss_of(x, wc, bc, wr, br, g, table, labels, mask, start=None):
        h = throughput_linear(x, wc, bc) if start is not None else x @ wc + bc
        h = throughput_linear(h, wr, br) if start is not None else h @ wr + br
        h = rmsnorm(h, {"w": g})
        return chunked_ce_loss(h, table.T, labels, mask, chunk=4,
                               vocab_start=start)
    whole = [t.clone().requires_grad_() for t in (x, wc, bc, wr, br, g,
                                                  table)]
    want = loss_of(*whole, labels, mask)
    want_g = torch.autograd.grad(want, whole)

    def rank_main(mesh):
        pol = ShardPolicy(dp=("data",), dp_size=data, model_size=model,
                          mesh=mesh)
        rows = slice(mesh.index("data") * 2, mesh.index("data") * 2 + 2)
        cuts = {"wc": ("data", "model"), "bc": ("model",),
                "wr": ("model", "data"), "br": ("model",), "g": ("model",),
                "table": ("model", "data")}
        leaves = {}
        for name, t in (("wc", wc), ("bc", bc), ("wr", wr), ("br", br),
                        ("g", g), ("table", table)):
            cut = sh.Cut(tuple(t.shape), cuts[name], mesh)
            # whole over 'data' (the step's gather), split over 'model'
            part = _slice(t, tuple(None if a == "data" else a
                                   for a in cuts[name]), mesh)
            leaves[name] = model_split(part.clone().requires_grad_(), cut)
        xl = x[rows].clone().requires_grad_()
        with use_policy(pol):
            loss = loss_of(xl, *leaves.values(), labels[rows], mask[rows],
                           start=sh.split_of(leaves["table"]).start)
        grads = torch.autograd.grad(loss, [xl, *leaves.values()])
        return (mesh.all_reduce(loss.detach(), "data"), rows,
                [grads[0]] + [mesh.all_reduce(t, "data") for t in grads[1:]],
                list(leaves.values()))
    want = float(want.detach())
    for loss, rows, grads, mine in on_threads(shape, rank_main):
        assert abs(float(loss) - want) <= 1e-5 * abs(want)
        parts = [want_g[0][rows]] + [
            ref if sh.split_of(t) is None else ref.narrow(
                sh.split_of(t).dim, sh.split_of(t).start, sh.split_of(t).step)
            for ref, t in zip(want_g[1:], mine)]
        for got, part, name in zip(grads, parts, ("x", "wc", "bc", "wr",
                                                  "br", "g", "table")):
            top = float(part.abs().max())
            assert float((got - part).abs().max()) <= 1e-5 * top, name
