"""The rank side of the ``test_torch_mesh*.py`` files: imports no jax and
nothing of the reference package, so that spawned ranks stay the port
alone.

``serve`` is the one serving run both sides make (the test process on the
1x1 mesh, every rank on its meshes), and ``train_run`` the one training
run; :func:`worlds` spawns four ranks on
each job file while the test process runs its own 1x1 runs; ``run_rank`` is
one spawned ``gloo`` rank on the CPU: it joins the group through a file
store, builds the meshes (2, 2), (4, 1) and (1, 4) over the same four
ranks, runs the job's cases (:data:`JOBS`: the dense model's matrix,
mixtral and the artifact, a family's runs such as :data:`FAMILY_RUNS`,
or mesh training: :data:`TRAIN_RUNS`, :data:`MOE_TRAIN_RUNS`) and saves
its results for the test process to read.
Each test file spawns its own world, so that ``--dist loadfile`` runs
them side by side.
"""
from __future__ import annotations

import contextlib
import dataclasses
import pathlib
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import make_local_mesh
from repro_torch.parallel.policy import use_policy
from repro_torch.parallel.sharding import split_of
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.engine import _leaves

MESHES = ((2, 2), (4, 1), (1, 4))
#: the engine of every run: chunked prefill over two chunks, a prefix
#: cache whose pages a later prompt hits
ENGINE = dict(slots=4, s_max=64, chunk_len=8, page_tokens=8,
              prefix_cache=True)
#: v3 also drafts (self-speculative decode at two planes)
SPEC = dict(spec_depth=2, spec_len=2)
#: MLA (deepseek: MoE, shared experts, the dense ``first0``) and the
#: vision frontend (llava): backend -> the meshes it serves on
FAMILY_RUNS = {"mla": {None: MESHES, "v2": MESHES, "v3": ((2, 2),)},
               "vision": {None: ((2, 2),), "v2": ((2, 2),)}}


def requests(vocab: int, seed: int = 0):
    """Six requests: ragged prompts, two sharing a 16-token prefix (the
    second, admitted in the second wave, hits the first's snapshot), one
    at temperature 0.7."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=16)
    lens = (5, 8, 7, 12, 6, 5)
    out = []
    for i, n in enumerate(lens):
        prompt = rng.integers(0, vocab, size=n)
        if i in (1, 5):
            prompt = np.concatenate([shared, prompt])
        out.append(Request(rid=i, prompt=prompt.astype(np.int64),
                           max_new_tokens=(4, 6, 3, 5, 4, 6)[i],
                           temperature=0.7 if i == 3 else 0.0))
    return out


def engine_kw(backend):
    return {**ENGINE, **(SPEC if backend == "v3" else {}),
            "backend": backend}


def serve(api, params, backend, mesh=None, seed=0, artifact=None,
          engine=None):
    """(tokens per request, the engine) of the requests through one engine
    (from ``artifact`` when given; ``engine`` overrides :data:`ENGINE`'s
    settings), two admission waves so the second wave's shared prompt
    hits the first's snapshot."""
    if artifact is not None:
        eng = ServeEngine.from_artifact(api, artifact, mesh=mesh,
                                        device="cpu", seed=seed,
                                        **{k: v for k, v in ENGINE.items()})
    else:
        eng = ServeEngine(api, params, mesh=mesh, device="cpu", seed=seed,
                          **{**engine_kw(backend), **(engine or {})})
    reqs = requests(api.cfg.vocab, seed)
    eng.run(reqs[:3], max_steps=200)
    eng.run(reqs[3:], max_steps=200)
    assert all(r.done for r in reqs), [r.outcome for r in reqs]
    return [r.out_tokens for r in reqs], eng


def prefill_logits(api, params, policy=None):
    """f32 logits of one ragged prefill window (behind seeded patches for
    a vision model, which ``plen`` counts; an enc-dec model's window is
    not ragged: 16 tokens over 16 seeded frames)."""
    reqs = requests(api.cfg.vocab)[:3]
    toks = np.zeros((3, 16), np.int64)
    for i, r in enumerate(reqs):
        toks[i, :min(len(r.prompt), 16)] = r.prompt[:16]
    plen = np.array([min(len(r.prompt), 16) for r in reqs])
    extra = {}
    if api.encdec:
        frames = torch.as_tensor(np.random.default_rng(6).standard_normal(
            (3, 16, api.cfg.d_model), dtype=np.float32))
        with use_policy(policy):
            return api.prefill(params, toks, s_max=32, frames=frames)[0]
    if api.cfg.frontend == "vision_stub":
        front = api.cfg.n_frontend_tokens
        extra["patches"] = torch.as_tensor(np.random.default_rng(5)
                                           .standard_normal(
            (3, front, api.cfg.d_model), dtype=np.float32))
        plen = plen + front
    with use_policy(policy):
        return api.prefill(params, toks, s_max=32, plen=plen, **extra)[0]


def _spy():
    """Record every float tensor a summing collective sees."""
    seen = []
    for name in ("all_reduce", "reduce_scatter", "reduce_scatter_tensor",
                 "reduce"):
        fn = getattr(dist, name)

        def spy(*a, _fn=fn, _name=name, **k):
            for t in list(a) + list(k.values()):
                ts = t if isinstance(t, (list, tuple)) else [t]
                if any(torch.is_tensor(x) and x.is_floating_point()
                       for x in ts):
                    seen.append(_name)
            return _fn(*a, **k)
        setattr(dist, name, spy)
    return seen


def _draft_spy(out):
    """Count the drafts, and the side leaves (recurrent states, rings) a
    draft left changed on this rank, which must be none."""
    inner = ServeEngine._draft
    out["drafts"], out["draft_changed"] = 0, []

    def draft(self, spec_rows):
        side = [{k: t.clone() for k, t in _leaves(layer)
                 if self._paged is None or not self._paged[i].get(k)}
                for i, layer in enumerate(self.caches)]
        got = inner(self, spec_rows)
        out["drafts"] += 1
        out["draft_changed"] += [
            (i, k) for i, keep in enumerate(side) for k, t in keep.items()
            if not torch.equal(dict(_leaves(self.caches[i]))[k], t)]
        return got
    ServeEngine._draft = draft


def _bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def _split_names(tree, path=""):
    if isinstance(tree, dict):
        if "sme_codes" in tree:
            return [path] if split_of(tree) is not None else []
        return [n for k, v in tree.items()
                for n in _split_names(v, f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _split_names(v, f"{path}/{i}")]
    return [path] if split_of(tree) is not None else []


def leaf_shapes(layer) -> dict:
    """{'/'-joined leaf name: shape} of one layer's cache (an enc-dec
    layer's ``self/k`` ... ``cross/v``, a recurrent layer's states)."""
    return {k: tuple(t.shape) for k, t in _leaves(layer)}


def _stale(eng):
    """The slots whose cross keys on this rank hold nonzero values past
    their source length: a later request with a shorter source reused a
    slot (ROADMAP R6)."""
    k = eng.caches[0]["cross"]["k"]
    return [slot for slot in range(eng.slots)
            if eng._local(slot) is not None
            and bool(k[eng._local(slot), int(eng._src[slot]):].abs().sum()
                     > 0)]


def _record(out, key, eng, api, shape):
    """A family run's tokens' bookkeeping (an enc-dec run's slots with
    stale cross keys), and on (2, 2) its prefill logits, split leaves and
    cache shard shapes."""
    out["mismatches"] += eng.rank_mismatches
    out["engine"][key] = {k: int(eng._m[k].value) for k in ("prefix_hits",
                                                           "spec_rounds")}
    out["states"][key] = [leaf_shapes(layer) for layer in eng.caches]
    if api.encdec:
        out.setdefault("stale", {})[key] = _stale(eng)
    if shape != (2, 2):
        return
    fkey = key[:2]
    out["logits"][fkey] = prefill_logits(api, eng.params, eng.policy)
    out["split"][fkey] = _split_names(eng.params)
    out["cache"][fkey] = list(leaf_shapes(eng.caches[0]).values())


def dense_job(job, meshes, out) -> None:
    """``_torch_small``'s qwen dense and v1-v3 on every mesh, and one
    ``decode_chunk`` per engine step."""
    api = job["api"]
    for backend, params in job["params"].items():
        for shape, mesh in meshes.items():
            toks, eng = serve(api, params, backend, mesh)
            out["tokens"][(backend, shape)] = toks
            out["mismatches"] += eng.rank_mismatches
            if shape == (2, 2):
                out["logits"][backend] = prefill_logits(api, eng.params,
                                                        eng.policy)
                out["split"][backend] = _split_names(eng.params)
                out["bytes"][backend] = _bytes(eng.params)
                out["cache"][backend] = [
                    tuple(t.shape) for t in eng.caches[0].values()]
    # one decode_chunk call per engine step on a mesh
    mesh = meshes[(2, 2)]
    eng = ServeEngine(api, job["params"]["v1"], mesh=mesh, device="cpu",
                      **engine_kw("v1"))
    calls = [0]
    inner = api.decode_chunk

    def counted(*a, **k):
        calls[0] += 1
        return inner(*a, **k)
    api.decode_chunk = counted
    pending = requests(api.cfg.vocab)
    steps = 0
    while pending or any(r is not None for r in eng.active):
        window = []
        while pending and len(window) < len(eng._free_slots()):
            window.append(pending.pop(0))
        if window:
            eng._admit(window)
        eng.step()
        steps += 1
        assert steps < 300
    api.decode_chunk = inner
    out["chunk_calls"] = (calls[0], eng.stats["decode_steps"], steps)


def moe_job(job, meshes, out) -> None:
    """mixtral dense and v2 on (2, 2); a reference ``.smez`` booted with
    ``from_artifact(mesh=)``."""
    mesh = meshes[(2, 2)]
    moe_api, moe = job["moe"]
    for backend, params in moe.items():
        toks, eng = serve(moe_api, params, backend, mesh)
        out["tokens"][("moe", backend)] = toks
        out["mismatches"] += eng.rank_mismatches
        out.setdefault("moe_split", {})[backend] = _split_names(eng.params)
    toks, eng = serve(job["api"], None, None, mesh, artifact=job["artifact"])
    out["tokens"][("artifact", (2, 2))] = toks
    out["artifact_split"] = _split_names(eng.params)


def family_job(job, meshes, out) -> None:
    """Each family's runs (``job["runs"]``: family -> backend -> meshes)
    on its params (``job["families"]``: family -> (api, backend ->
    params)), the engine's settings overridden by ``job["engine"]``."""
    for fam, (fam_api, fam_params) in job["families"].items():
        for backend, shapes in job["runs"][fam].items():
            for shape in shapes:
                toks, eng = serve(fam_api, fam_params[backend], backend,
                                  meshes[shape], engine=job.get("engine"))
                key = (fam, backend, shape)
                out["tokens"][key] = toks
                _record(out, key, eng, fam_api, shape)


#: the mesh training runs: (mesh shape, microbatches)
TRAIN_RUNS = tuple((shape, micro) for shape in MESHES for micro in (1, 2))


def train_optimizer():
    """The train runs' AdamW: weight decay 0.01, clip 1.0, cosine."""
    from repro_torch.optim import adamw, cosine_schedule
    return adamw(cosine_schedule(3e-3, 1, 4), weight_decay=0.01)


def recording(opt, seen):
    """``opt`` whose update first hands its gradient tree to ``seen``."""
    def update(grads, state, params, step):
        seen(grads)
        return opt.update(grads, state, params, step)
    return dataclasses.replace(opt, update=update)


def train_run(api, params, batches, micro, mesh=None):
    """Two steps of ``make_train_step`` (on ``mesh``, over this rank's
    throughput shards): the losses, each step's pre-clip norm, the first
    step's gradient shards, and the params, ``m`` and ``v`` after the
    steps (gathered whole on a mesh), with this rank's bytes of params +
    ``m`` + ``v``."""
    from repro_torch.optim import global_norm
    from repro_torch.parallel.sharding import (gather_throughput,
                                               place_throughput)
    from repro_torch.train import make_train_step
    from repro_torch.tree import tree_map
    norms, grads = [], []

    def seen(g):
        norms.append(float(global_norm(g)))
        grads.append(tree_map(torch.Tensor.detach, g))   # without a Cut
    opt = recording(train_optimizer(), seen)
    step = make_train_step(api.train_loss, opt, micro, mesh=mesh)
    if mesh is not None:
        params = place_throughput(params, mesh)
    state = opt.init(params)
    losses = []
    for i, batch in enumerate(batches):
        params, state, loss = step(params, state, i, batch)
        losses.append(loss)
    out = dict(losses=losses, norms=norms, grads=grads[0],
               bytes=_bytes(params) + _bytes(state["m"])
               + _bytes(state["v"]))
    if mesh is not None:
        params = gather_throughput(params, mesh)
        state = {k: gather_throughput(v, mesh) for k, v in state.items()}
    return dict(out, params=params, m=state["m"], v=state["v"])


@contextlib.contextmanager
def routes():
    """Every ``moe_apply`` call's top-k expert indices [G, S, k] (the
    ones its dispatch takes), in call order."""
    from repro_torch.models import moe
    seen = []
    inner = moe._group_dispatch

    def spy(xg, idx, *rest):
        seen.append(idx.detach().clone())
        return inner(xg, idx, *rest)
    moe._group_dispatch = spy
    try:
        yield seen
    finally:
        moe._group_dispatch = inner


#: the MoE and MLA mesh training runs: (model, mesh shape,
#: microbatches); ``mixtral-e6``'s 6 experts do not divide (1, 4)'s
#: 'model' axis, so its stacks are expert-TP there
MOE_TRAIN_RUNS = tuple((model, shape, micro)
                       for model in ("mixtral", "deepseek")
                       for shape in MESHES for micro in (1, 2)) + (
    ("mixtral-e6", (1, 4), 1),)


def moe_train_run(api, params, batches, micro, mesh=None):
    """:func:`train_run` without the gradient, with every MoE layer's
    routes of both steps."""
    with routes() as seen:
        run = train_run(api, params, batches, micro, mesh)
    run.pop("grads")
    return dict(run, routes=seen)


def moe_train_job(job, meshes, out) -> None:
    """Mesh training of the MoE family and MLA (``job["runs"]``, of
    :data:`MOE_TRAIN_RUNS`, over ``job["models"]``: name -> (api,
    params, batches)); each run's expert stacks' specs and shards."""
    from repro_torch.parallel.sharding import cut_of, place_throughput
    out["train"], out["experts"] = {}, {}
    for name, shape, micro in job["runs"]:
        api, params, batches = job["models"][name]
        key = (name, shape, micro)
        out["train"][key] = moe_train_run(api, params, batches, micro,
                                          meshes[shape])
        layer = params["blocks"][0]["mlp"]
        placed = place_throughput({k: layer[k] for k in ("wi", "wo")},
                                  meshes[shape])
        # each stack's spec and this rank's shard shape
        out["experts"][key] = {k: (cut_of(t).spec, tuple(t.shape))
                               for k, t in placed.items()}


def _error(fn) -> str:
    """The ``ValueError`` message of ``fn()`` ("" when it returns)."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def train_job(job, meshes, out) -> None:
    """Mesh training of the dense model (:data:`TRAIN_RUNS`); the shards
    placed and gathered back; ``ef_allreduce`` over the 'data' groups of
    (2, 2) and (4, 1) on the first step's gradient; a packed tree and an
    recurrent model refused."""
    from repro_torch.parallel.compress import ef_allreduce, zeros_like_resid
    from repro_torch.parallel.sharding import (gather_throughput,
                                               place_throughput)
    from repro_torch.train import make_train_step
    from repro_torch.tree import flatten
    api, params, batches = job["api"], job["params"], job["batches"]
    out["train"], out["ef"], out["shards"] = {}, {}, {}
    for shape, micro in TRAIN_RUNS:
        run = train_run(api, params, batches, micro, meshes[shape])
        out["train"][(shape, micro)] = run
        if micro == 1 and shape in ((2, 2), (4, 1)):
            g = run["grads"]
            deq, resid = ef_allreduce(g, zeros_like_resid(g), "data",
                                      meshes[shape])
            out["ef"][shape] = dict(g=g, deq=deq, resid=resid)
    for shape, mesh in meshes.items():
        placed = place_throughput(params, mesh)
        out["shards"][shape] = dict(
            shapes={k: tuple(t.shape) for k, t in flatten(placed).items()},
            back=gather_throughput(placed, mesh))
    mesh = meshes[(2, 2)]
    step = make_train_step(api.train_loss, train_optimizer(), mesh=mesh)
    out["refused"] = {
        "packed": _error(lambda: step(job["packed"], None, 0, batches[0])),
        "recurrent": _error(lambda: make_train_step(
            job["recurrent"][0].train_loss, train_optimizer(), mesh=mesh)(
            place_throughput(job["recurrent"][1], mesh), None, 0,
            job["recurrent"][2]))}


#: job kind -> what a rank runs
JOBS = {"dense": dense_job, "moe": moe_job, "family": family_job,
        "train": train_job, "train_moe": moe_train_job}


def run_rank(rank: int, world: int, store: str, tmp: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    tmp = pathlib.Path(tmp)
    job = torch.load(tmp / "job.pt", weights_only=False)
    seen = _spy()
    meshes = {s: make_local_mesh(*s, device="cpu") for s in MESHES}
    out = {"tokens": {}, "mismatches": 0, "logits": {}, "split": {},
           "bytes": {}, "cache": {}, "engine": {}, "states": {}}
    _draft_spy(out)
    JOBS[job["kind"]](job, meshes, out)
    out["summed"] = list(seen)
    out["jax"] = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "repro"))
    torch.save(out, tmp / f"rank{rank}.pt")
    dist.destroy_process_group()


def worlds(tmp, jobs: dict, local):
    """(``local()``, {name: every rank's results}): for each of ``jobs``
    ({name: job}) a world of four ``gloo`` ranks, all spawned at once (a
    rank mostly waits on its gathers, so the worlds overlap), while this
    process runs ``local``, its own 1x1 runs."""
    procs = {}
    for name, job in jobs.items():
        d = pathlib.Path(tmp) / name
        d.mkdir(parents=True, exist_ok=True)
        torch.save(job, d / "job.pt")
        procs[name] = (d, torch.multiprocessing.start_processes(
            run_rank, args=(4, str(d / "store"), str(d)), nprocs=4,
            join=False, start_method="spawn"))
    ref = local()
    for _, ctx in procs.values():
        while not ctx.join():
            pass
    return ref, {name: [torch.load(d / f"rank{r}.pt", weights_only=False)
                        for r in range(4)]
                 for name, (d, _) in procs.items()}


def world(tmp, job: dict, local):
    """(``local()``, every rank's results) of one world on ``job``
    (:func:`worlds`)."""
    ref, ranks = worlds(tmp, {"world": job}, local)
    return ref, ranks["world"]
