"""A world of CPU processes for the port's parallel tests.

``run_world(world, tmp_path, jobs)`` spawns ``world`` ranks once
(``torch.multiprocessing.spawn``), joins them over gloo with a
``file://`` rendezvous under ``tmp_path`` and runs every job on every
rank in order: a job names a function of this module, its input file and
its output file.  Each input is an ``.npz`` of arrays and a JSON ``meta``
entry written by the test; rank 0 writes the job's output ``.npz``.

The ranks import this module, torch and the port, never JAX: the tests
compute JAX's side in the pytest process and pass only numpy across.
Nested trees cross as ``a/b/c`` keys (``save_tree`` / ``load_tree``).
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os

import numpy as np
import torch

META = "__meta__"


# ---------------------------------------------------------------------------
# Trees in .npz files
# ---------------------------------------------------------------------------


def flatten(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def unflatten(flat: dict, prefix: str = "") -> dict:
    out: dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix) or key == META:
            continue
        node = out
        parts = key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def save_tree(path, tree: dict, meta=None) -> None:
    flat = {k: _np(v) for k, v in flatten(tree).items()}
    if meta is not None:
        flat[META] = np.asarray(json.dumps(meta))
    np.savez(path, **flat)


def load_tree(path) -> tuple:
    """``(tree, meta)``."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    meta = json.loads(str(flat[META])) if META in flat else None
    return unflatten(flat), meta


# ---------------------------------------------------------------------------
# The world
# ---------------------------------------------------------------------------


def _rank_main(rank: int, world: int, rdv: str, jobs: list) -> None:
    torch.set_num_threads(1)
    from megatron_llm_tpu_torch import initialize

    initialize.initialize_distributed(
        "cpu", init_method=f"file://{rdv}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=120))
    try:
        for fn_name, in_path, out_path in jobs:
            tree, meta = load_tree(in_path)
            out = globals()[fn_name](tree, meta)
            if rank == 0 and out is not None:
                save_tree(out_path, out)
            initialize.barrier()
    finally:
        initialize.destroy()


# what every rank imports, loaded once into the fork server that forks
# the ranks (a spawned rank would import torch and the port anew)
PRELOAD = ["torch_world", "megatron_llm_tpu_torch.initialize",
           "megatron_llm_tpu_torch.training.driver",
           "megatron_llm_tpu_torch.serving"]


def run_world(world: int, tmp_path, jobs: list) -> list:
    """Run ``jobs`` (``(function name, input tree, meta)``) on a world of
    ``world`` ranks → each job's output tree (rank 0's).  The ranks are
    forked by a fork server of their own (started clean, never from the
    pytest process with JAX's threads in it) that has ``PRELOAD``
    imported."""
    import multiprocessing

    import torch.multiprocessing as mp

    tmp_path = str(tmp_path)
    specs = []
    for i, (fn_name, tree, meta) in enumerate(jobs):
        in_path = os.path.join(tmp_path, f"in{i}.npz")
        save_tree(in_path, tree, meta)
        specs.append((fn_name, in_path, os.path.join(tmp_path, f"out{i}.npz")))
    multiprocessing.set_forkserver_preload(PRELOAD)
    mp.start_processes(_rank_main,
                       args=(world, os.path.join(tmp_path, "rdv"), specs),
                       nprocs=world, join=True, start_method="forkserver")
    return [load_tree(out)[0] if os.path.exists(out) else None
            for _, _, out in specs]


# ---------------------------------------------------------------------------
# Rank-side cases (torch and the port only)
# ---------------------------------------------------------------------------


def _t(tree):
    """numpy tree → torch tree (ints as int64, floats kept)."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def runtime_config(meta: dict):
    """The port's ``RuntimeConfig`` of ``meta``'s ``model`` (a preset name
    and its kwargs), ``parallel``, ``optimizer`` and ``train`` kwargs."""
    from megatron_llm_tpu_torch import config as C

    preset, mkw = meta["model"]
    model = getattr(C, preset)(**mkw)
    return C.RuntimeConfig(
        model=model, parallel=C.ParallelConfig(**meta.get("parallel", {})),
        optimizer=C.OptimizerConfig(**meta.get("optimizer", {})),
        train=C.TrainConfig(**meta.get("train", {}))).validate()


def _specs(cfg, kind: str):
    from megatron_llm_tpu_torch.models import biencoder, encdec, sharding

    return {"lm": sharding.param_specs,
            "bert": encdec.bert_param_specs,
            "t5": encdec.t5_param_specs,
            "ict": biencoder.biencoder_param_specs}[kind](cfg.model,
                                                          cfg.parallel)


def _loss(cfg, kind: str, params, batch, rng):
    from megatron_llm_tpu_torch.models import biencoder, encdec
    from megatron_llm_tpu_torch.training import step as st

    if kind == "lm":
        return st.compute_loss(cfg, params, batch, rng=rng)
    fn = {"bert": encdec.bert_loss, "t5": encdec.t5_loss,
          "ict": biencoder.retrieval_loss}[kind]
    return fn(cfg.model, params, batch, rng, rng is None)


def grads_case(tree: dict, meta: dict) -> dict:
    """One microbatch's loss and whole grads on this world's mesh: the
    params are the whole tree (cut to this rank's shards), the batch the
    global microbatch (cut to this rank's dp block)."""
    from megatron_llm_tpu_torch.models import sharding
    from megatron_llm_tpu_torch.ops import dropout as drop
    from megatron_llm_tpu_torch.parallel import mesh as mesh_lib
    from megatron_llm_tpu_torch.training import step as st
    from megatron_llm_tpu_torch.training.driver import _dp_block
    from megatron_llm_tpu_torch.utils.tree import tree_map

    cfg = runtime_config(meta)
    kind = meta.get("kind", "lm")
    mesh = mesh_lib.build_mesh(cfg.parallel)
    specs = _specs(cfg, kind)
    params = sharding.shard_params(_t(tree["params"]), specs, mesh)
    batch = {k: torch.from_numpy(v) for k, v in
             _dp_block({k: np.asarray(v) for k, v in tree["batch"].items()},
                       mesh, axis=0).items()}
    rng = None if meta.get("seed") is None else drop.key(meta["seed"])
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    batch = st.loss_denominators(batch, mesh.group("dp"), lead=0,
                                 whole=mesh.size("cp") > 1)
    batch = st.context_parallel_block(cfg, batch, mesh)
    with mesh_lib.use_mesh(mesh):
        loss = _loss(cfg, kind, live, batch, rng)
        loss.backward()
        grads = tree_map(lambda p: p.grad if p.grad is not None
                         else torch.zeros_like(p), live)
        plan = st.make_plan(cfg, mesh, specs, params)
        if plan is not None:
            grads, loss = st.reduce_grads(plan, grads, loss.detach())
        grads = sharding.gather_params(grads, specs, mesh)
        out = {"loss": loss.detach(), "grads": grads}
        if meta.get("logits"):
            from megatron_llm_tpu_torch.models import encdec
            from megatron_llm_tpu_torch.parallel import mappings

            with torch.no_grad():
                b = batch
                logits = encdec.t5_forward(
                    cfg.model, params, b["enc_tokens"], b["dec_tokens"],
                    b["enc_pad_mask"], b["dec_pad_mask"])
                out["logits"] = mappings.all_gather(
                    logits, mesh.group("tp"), -1)
    return out


def ce_case(tree: dict, meta: dict) -> dict:
    """Vocab-parallel CE over this rank's block of whole logits: the
    per-token loss, the gathered grad of its sum, and the greedy ids."""
    from megatron_llm_tpu_torch.config import ParallelConfig
    from megatron_llm_tpu_torch.parallel import cross_entropy as ce
    from megatron_llm_tpu_torch.parallel import mappings
    from megatron_llm_tpu_torch.parallel import mesh as mesh_lib

    mesh = mesh_lib.build_mesh(ParallelConfig(
        tensor_parallel=meta["tp"], data_parallel=meta.get("dp", 1)))
    group = mesh.group("tp")
    logits = mappings.split(torch.from_numpy(tree["logits"]), group, -1)
    logits = logits.contiguous().requires_grad_(True)
    targets = torch.from_numpy(tree["targets"])
    loss = ce.vocab_parallel_cross_entropy(
        logits, targets, group, label_smoothing=meta["smoothing"],
        vocab_size=meta.get("vocab_size"))
    loss.sum().backward()
    return {"loss": loss.detach(),
            "grad": mappings.all_gather(logits.grad, group, -1),
            "argmax": ce.vocab_parallel_max_indices(logits.detach(), group)}


def pretrain_case(tree: dict, meta: dict) -> dict:
    """``training.driver.pretrain`` over the given whole params and global
    batches (a ``batch_provider``): each step's loss, and the whole params
    and moments at the end (``meta["save"]``/``["load"]`` set the
    checkpoint roots)."""
    from megatron_llm_tpu_torch import checkpointing
    from megatron_llm_tpu_torch.training import driver

    from megatron_llm_tpu_torch import metrics as metrics_lib

    cfg = runtime_config(meta)
    batches = [tree["batches"][str(i)] for i in range(len(tree["batches"]))]
    provider = poisoned_provider(batches, *meta.get("poison", (0, 0)))
    metrics_lib.RESILIENCE_EVENTS.reset()
    losses = []
    params = _t(tree["params"]) if "params" in tree else None
    state = driver.pretrain(cfg, params=params, batch_provider=provider,
                            device="cpu", on_step=lambda it, m, s:
                            losses.append(float(m["loss"])))
    art_plan = _plan_of(cfg, state)
    if art_plan is not None:  # every leaf whole
        from megatron_llm_tpu_torch.models import sharding

        from megatron_llm_tpu_torch.parallel import pipeline as pipe

        state = checkpointing.map_train_state(
            lambda t, s: sharding.gather_tensor(t, s, art_plan.mesh), state,
            art_plan)

        def whole(tree):  # the [L, ...] layer stack
            return pipe.from_pipeline_params(tree, cfg.parallel)

        state = state._replace(params=whole(state.params), opt=state.opt.
                               _replace(mu=whole(state.opt.mu),
                                        nu=state.opt.nu and whole(
                                            state.opt.nu)))
    out = {"losses": np.asarray(losses), "params": state.params,
           "mu": state.opt.mu, "rollbacks": np.asarray(
               metrics_lib.RESILIENCE_EVENTS.get("rollbacks"))}
    if state.opt.nu is not None:
        out["nu"] = state.opt.nu
    return out


def ckpt_leaves_case(tree: dict, meta: dict) -> dict:
    """``setup_train_state``, a save and a load at ``meta``'s degrees with
    every whole leaf of a sharded one watched (its storage's weakref): the
    most earlier wholes still alive when the next is made, over every
    rank (0: one whole leaf at a time), and whether every rank's loaded
    blocks equal the saved state's bit for bit."""
    import itertools
    import weakref

    import torch.distributed as dist

    from megatron_llm_tpu_torch import checkpointing
    from megatron_llm_tpu_torch.models import sharding
    from megatron_llm_tpu_torch.training import driver
    from megatron_llm_tpu_torch.utils.tree import tree_leaves

    watched: list = []
    most = {"init": 0, "save": 0, "load": 0}
    made = dict.fromkeys(most, 0)
    phase = ["init"]

    def alive() -> int:
        return sum(r() is not None for r in watched)

    def note(whole: torch.Tensor) -> None:
        most[phase[0]] = max(most[phase[0]], alive())
        made[phase[0]] += 1
        watched.append(weakref.ref(whole.untyped_storage()))

    shard, gather = sharding.shard_tensor, sharding.gather_tensor

    def watched_shard(t, spec, mesh):
        out = shard(t, spec, mesh)
        if out is not t:  # t is the whole of a sharded leaf
            note(t)
        return out

    def watched_gather(t, spec, mesh):
        out = gather(t, spec, mesh)
        if out is not t:
            note(out)
        return out

    cfg = runtime_config(meta)
    sharding.shard_tensor, sharding.gather_tensor = watched_shard, \
        watched_gather
    try:
        art = driver.setup_train_state(cfg, device="cpu")
        plan = art.plan
        watched.clear()

        seeds = itertools.count(1)

        def fill(t, spec):  # distinct values, the same whole on every rank
            g = torch.Generator().manual_seed(next(seeds))
            whole = torch.randn(checkpointing._whole_shape(
                t, spec, plan.mesh), generator=g).to(t.dtype)
            with torch.no_grad():
                return t.copy_(shard(whole, spec, plan.mesh))

        state = checkpointing.map_train_state(fill, art.state, plan)
        phase[0] = "save"
        checkpointing.save_checkpoint(meta["root"], state, iteration=1,
                                      plan=plan)
        watched.clear()
        phase[0] = "init"
        template = driver.setup_train_state(
            cfg, device="cpu").state  # new params, zero moments
        watched.clear()
        phase[0] = "load"
        loaded, _ = checkpointing.load_checkpoint(meta["root"], template,
                                                  plan=plan)
    finally:
        sharding.shard_tensor, sharding.gather_tensor = shard, gather
    def leaves(st):
        return tree_leaves(st.params) + [
            t for tree in (st.opt.master, st.opt.mu, st.opt.nu)
            if tree is not None for t in tree_leaves(tree)]

    same = all(torch.equal(a, b) for a, b in zip(leaves(loaded),
                                                 leaves(state)))
    counts = torch.tensor([most["init"], most["save"], most["load"],
                           int(not same)])
    dist.all_reduce(counts, op=dist.ReduceOp.MAX)
    return {"most_alive": counts[:3], "differ": counts[3],
            "made": torch.tensor([made["init"], made["save"],
                                  made["load"]])}


def poisoned_provider(batches: list, lo: int = 0, hi: int = 0):
    """A ``batch_provider`` over global batches; the samples in ``[lo,
    hi)`` NaN-poisoned (``resilience.poison_nan``), the poison following
    the data position as a bad corpus shard's does."""
    from megatron_llm_tpu_torch.resilience import poison_nan

    def provider(consumed, gbs):
        i = consumed // gbs
        while True:
            batch = {k: np.asarray(v) for k, v in batches[i].items()}
            if i * gbs < hi and (i + 1) * gbs > lo:
                batch = poison_nan(batch)
            yield batch
            i += 1

    return provider


def _plan_of(cfg, state):
    """The plan ``setup_train_state`` made for ``state`` (rebuilt: the
    mesh's groups are the world's, so a second mesh is one more set)."""
    from megatron_llm_tpu_torch.models import sharding
    from megatron_llm_tpu_torch.parallel import mesh as mesh_lib
    from megatron_llm_tpu_torch.training import step as st

    from megatron_llm_tpu_torch.parallel import pipeline as pipe

    mesh = mesh_lib.build_mesh(cfg.parallel)
    return st.make_plan(cfg, mesh, pipe.pipeline_param_specs(
        sharding.param_specs(cfg.model, cfg.parallel), cfg.parallel),
        state.params)


def entry_case(tree: dict, meta: dict) -> dict:
    """An entry's ``main(argv, device="cpu")`` (``pretrain_bert``,
    ``pretrain_t5``, ``pretrain_ict``, ``finetune``) on this world; the
    log's losses (rank 0 prints them)."""
    import contextlib
    import importlib
    import io
    import re

    entry = importlib.import_module(f"megatron_llm_tpu_torch.{meta['entry']}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if meta["entry"] == "finetune":
            rc = entry.main(meta["argv"])
            iters = rc
        else:
            iters = int(entry.main(meta["argv"], device="cpu").iteration)
    text = buf.getvalue()
    losses = [float(x) for x in re.findall(r"lm loss: ([0-9.E+-]+) \|", text)]
    valid = [float(x) for x in re.findall(
        r"validation loss at .*? lm_loss: ([0-9.E+-]+) \|", text)]
    return {"losses": np.asarray(losses), "valid": np.asarray(valid),
            "iters": np.asarray(iters)}


def mailbox_case(tree: dict, meta: dict) -> dict:
    """``parallel.mappings.DeviceMailbox`` over boxes of shared host memory
    (a file each rank maps), small enough that every tensor goes in
    pieces, against gloo's own collectives on the same inputs."""
    import torch.distributed as dist

    from megatron_llm_tpu_torch.parallel import mappings

    nbytes = 4096
    rank, n = dist.get_rank(), dist.get_world_size()
    paths = [os.path.join(meta["dir"], f"box{r}") for r in range(n)]
    with open(paths[rank], "wb") as f:
        f.write(bytes(nbytes))
    dist.barrier()
    boxes = [torch.from_file(p, shared=True, size=nbytes, dtype=torch.uint8)
             for p in paths]
    box = mappings.DeviceMailbox(dist.group.WORLD, boxes, torch.device("cpu"))
    mappings.MAILBOX_BYTES = nbytes
    x = torch.from_numpy(tree["x"][rank]).clone()   # [rows, cols] float32
    out = {}
    for name, op in (("sum", dist.ReduceOp.SUM), ("max", dist.ReduceOp.MAX)):
        want = x.clone()
        dist.all_reduce(want, op=op)
        out[f"{name}_mailbox"] = box.all_reduce(x.clone(), op)
        out[f"{name}_gloo"] = want
    gathered = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]))
    mappings._all_gather(gathered, x.clone(), group=dist.group.WORLD)
    out["gather_mailbox"] = box.all_gather(x.clone())
    out["gather_gloo"] = gathered
    half = box.all_gather(x.to(torch.bfloat16))
    out["gather_bf16_exact"] = torch.tensor(bool(torch.equal(
        half, gathered.to(torch.bfloat16))))
    return out


# ---------------------------------------------------------------------------
# Pipeline, context and expert parallelism
# ---------------------------------------------------------------------------


def pipeline_case(tree: dict, meta: dict) -> dict:
    """The pipelined loss and whole grads (``[L, ...]`` layout) of whole
    params and a global batch ``[M, mb * dp, s]`` on this world's mesh
    (under cp each rank its block of the sequence, as the step cuts it);
    ``meta["windows"]`` runs each window of the list too (its loss and
    grads as ``loss_w<W>`` / ``grads_w<W>``); ``meta["metrics"]`` runs the
    pipelined eval step instead."""
    from megatron_llm_tpu_torch.models import sharding
    from megatron_llm_tpu_torch.parallel import mesh as mesh_lib
    from megatron_llm_tpu_torch.parallel import pipeline as pipe
    from megatron_llm_tpu_torch.training import driver
    from megatron_llm_tpu_torch.training import step as st

    cfg = runtime_config(meta)
    mesh = mesh_lib.build_mesh(cfg.parallel)
    specs = pipe.pipeline_param_specs(
        sharding.param_specs(cfg.model, cfg.parallel), cfg.parallel)
    params = sharding.shard_params(
        pipe.to_pipeline_params(_t(tree["params"]), cfg.parallel), specs,
        mesh)
    batch = {k: torch.from_numpy(v) for k, v in driver._dp_block(
        {k: np.asarray(v) for k, v in tree["batch"].items()}, mesh).items()}
    batch = st.loss_denominators(batch, mesh.group("dp"),
                                 whole=mesh.size("cp") > 1)
    out = {}
    with mesh_lib.use_mesh(mesh):
        if meta.get("metrics"):
            step = driver.make_pipeline_eval_step(cfg, tuple(meta["metrics"]),
                                                  device="cpu")
            res = step(params, batch)
            return {k: driver._dp_mean({k: float(v)}, mesh)[k]
                    for k, v in res.items()}
        plan = st.make_plan(cfg, mesh, specs, params)
        batch = st.context_parallel_block(cfg, batch, mesh)
        for w in [None] + list(meta.get("windows", ())):
            c = cfg if w is None else dataclasses.replace(
                cfg, parallel=dataclasses.replace(
                    cfg.parallel, pipeline_remat_window=w)).validate()
            grads, loss, aux, _ = pipe.pipeline_grads(c, params, batch)
            loss = loss + pipe.aux_term(c, aux, batch["tokens"].shape[0])
            grads, loss = st.reduce_grads(plan, grads, loss)
            grads = pipe.from_pipeline_params(
                sharding.gather_params(grads, specs, mesh), cfg.parallel)
            tag = "" if w is None else f"_w{w}"
            out["loss" + tag] = loss
            out["grads" + tag] = grads
    return out


def ring_case(tree: dict, meta: dict) -> dict:
    """Ring attention over this world's cp group on global ``q, k, v``
    (and ``seg``): each rank's shard of the (zigzag-ordered, where
    ``meta["zigzag"]``) sequence, the output and the grads of ``sum(out *
    w)`` gathered back to the natural order."""
    import torch.distributed as dist

    from megatron_llm_tpu_torch.config import ParallelConfig
    from megatron_llm_tpu_torch.parallel import mappings
    from megatron_llm_tpu_torch.parallel import mesh as mesh_lib
    from megatron_llm_tpu_torch.parallel import ring_attention as ring

    n = dist.get_world_size()
    mesh = mesh_lib.build_mesh(ParallelConfig(context_parallel=n))
    group, r = mesh.group("cp"), mesh.index("cp")
    s = tree["q"].shape[1]
    order = (ring.zigzag_indices(s, n) if meta.get("zigzag")
             else np.arange(s))
    blk = order[r * (s // n):(r + 1) * (s // n)]
    q, k, v = (torch.from_numpy(tree[x][:, blk]).requires_grad_(True)
               for x in ("q", "k", "v"))
    seg = torch.from_numpy(tree["seg"][:, blk]) if "seg" in tree else None
    w = torch.from_numpy(tree["w"][:, blk])
    with mesh_lib.use_mesh(mesh):
        if meta.get("zigzag"):
            o = ring.ring_attention_zigzag(q, k, v, segment_ids=seg)
        else:
            o = ring.ring_attention(q, k, v, causal=meta["causal"],
                                    segment_ids=seg)
    (o * w).sum().backward()
    inv = np.argsort(order)

    def whole(t):
        return mappings.all_gather(t.detach().contiguous(), group, 1)[:, inv]

    return {"out": whole(o), "dq": whole(q.grad), "dk": whole(k.grad),
            "dv": whole(v.grad)}


def eval_case(tree: dict, meta: dict) -> dict:
    """``driver.make_eval_step`` on whole params and a global eval batch
    ``[b, s]`` at this world's degrees (each rank its dp block): the
    loss and metrics, averaged over dp."""
    from megatron_llm_tpu_torch.models import sharding
    from megatron_llm_tpu_torch.parallel import mesh as mesh_lib
    from megatron_llm_tpu_torch.training import driver

    cfg = runtime_config(meta)
    mesh = mesh_lib.build_mesh(cfg.parallel)
    params = sharding.shard_params(
        _t(tree["params"]), sharding.param_specs(cfg.model, cfg.parallel),
        mesh)
    batch = {k: torch.from_numpy(v) for k, v in driver._dp_block(
        {k: np.asarray(v) for k, v in tree["batch"].items()}, mesh,
        axis=0).items()}
    step = driver.make_eval_step(cfg, tuple(meta.get("metrics", ())),
                                 device="cpu")
    with mesh_lib.use_mesh(mesh):
        res = step(params, driver._eval_denominators(batch, mesh))
    return driver._dp_mean({k: float(v) for k, v in res.items()}, mesh)


def moe_forward_case(tree: dict, meta: dict) -> dict:
    """The MoE model's logits and aux on whole params and tokens at this
    world's degrees (the expert leaves cut over ep, the batch over dp),
    gathered over dp."""
    from megatron_llm_tpu_torch.models import model as model_lib
    from megatron_llm_tpu_torch.models import sharding
    from megatron_llm_tpu_torch.parallel import mappings
    from megatron_llm_tpu_torch.parallel import mesh as mesh_lib
    from megatron_llm_tpu_torch.training import driver

    cfg = runtime_config(meta)
    mesh = mesh_lib.build_mesh(cfg.parallel)
    params = sharding.shard_params(
        _t(tree["params"]), sharding.param_specs(cfg.model, cfg.parallel),
        mesh)
    tokens = torch.from_numpy(driver._dp_block(
        {"t": np.asarray(tree["tokens"])}, mesh, axis=0)["t"])
    with mesh_lib.use_mesh(mesh), torch.no_grad():
        logits = model_lib.forward(cfg.model, params, tokens)
    return {"logits": mappings.all_gather(logits, mesh.group("dp"), 0)}


def ppermute_case(tree: dict, meta: dict) -> dict:
    """``mappings.ppermute`` forward and backward over the world (gloo):
    the identity, a rotation and a partial permutation against gloo's own
    all-gather of the inputs; the shared-memory mailbox's point-to-point
    exchange (small boxes: the tensor goes in pieces) against gloo's; and
    the refusals (a non-permutation, an NCCL group's CPU tensor)."""
    import torch.distributed as dist

    from megatron_llm_tpu_torch.parallel import mappings

    g = dist.group.WORLD
    rank, n = dist.get_rank(), dist.get_world_size()
    x = torch.from_numpy(tree["x"][rank]).clone().requires_grad_(True)
    out = {}
    perms = {"identity": [(r, r) for r in range(n)],
             "rotation": [(r, (r + 1) % n) for r in range(n)],
             "partial": [(0, n - 1)]}
    for name, perm in perms.items():
        y = mappings.ppermute(x, g, perm)
        w = torch.from_numpy(tree["w"][rank])
        (gx,) = torch.autograd.grad((y * w).sum(), x)
        out[f"{name}_out"] = mappings.all_gather(y.detach()[None], g, 0)
        out[f"{name}_grad"] = mappings.all_gather(gx[None], g, 0)
    nbytes = 64
    paths = [os.path.join(meta["dir"], f"pbox{r}") for r in range(n)]
    with open(paths[rank], "wb") as f:
        f.write(bytes(nbytes))
    dist.barrier()
    boxes = [torch.from_file(p, shared=True, size=nbytes, dtype=torch.uint8)
             for p in paths]
    box = mappings.DeviceMailbox(g, boxes, torch.device("cpu"))
    old = mappings.MAILBOX_BYTES
    mappings.MAILBOX_BYTES = nbytes
    try:
        rot = perms["rotation"]
        got = box.permute(x.detach().clone(), rot)
        want = mappings._permute(x.detach(), g, rot)
        out["mailbox_equal"] = torch.tensor(bool(torch.equal(got, want)))
        part = box.permute(x.detach().clone(), perms["partial"])
        out["mailbox_partial"] = mappings.all_gather(part[None], g, 0)
    finally:
        mappings.MAILBOX_BYTES = old
    refused = []
    try:
        mappings.ppermute(x.detach(), g, [(0, 1), (1, 1)])
    except ValueError:
        refused.append("not_a_permutation")
    real = mappings._gloo
    mappings._gloo = lambda group: False  # as an NCCL group would answer
    try:
        mappings.ppermute(x.detach(), g, perms["rotation"])
    except RuntimeError as e:
        if "cannot move cpu tensors" in str(e):
            refused.append("nccl_cpu")
    finally:
        mappings._gloo = real
    out["refused"] = np.asarray(",".join(refused))
    return out


# ---------------------------------------------------------------------------
# The encoder pipelines, custom losses under cp, MoE under cp and SP
# ---------------------------------------------------------------------------


def _encdec_pipeline(kind: str):
    from megatron_llm_tpu_torch.parallel import pipeline_encdec as pe

    return {"t5": (pe.t5_to_pipeline_params, pe.t5_pipeline_param_specs,
                   pe.t5_pipeline_loss),
            "bert": (pe.bert_to_pipeline_params, pe.bert_pipeline_param_specs,
                     pe.bert_pipeline_loss)}[kind]


def encdec_pipeline_case(tree: dict, meta: dict) -> dict:
    """The split-rank (T5) or encoder (BERT) pipeline's loss and whole
    staged grads (``[pp, lpc, ...]``) of whole params in the unpipelined
    layout and a global batch ``[M, mb * dp, ...]`` at this world's
    degrees, reduced as the step reduces them."""
    from megatron_llm_tpu_torch.models import sharding
    from megatron_llm_tpu_torch.parallel import mesh as mesh_lib
    from megatron_llm_tpu_torch.training import driver
    from megatron_llm_tpu_torch.training import step as st

    cfg = runtime_config(meta)
    to_staged, specs_of, loss_fn = _encdec_pipeline(meta["kind"])
    mesh = mesh_lib.build_mesh(cfg.parallel)
    specs = specs_of(cfg.model, cfg.parallel)
    params = sharding.shard_params(
        to_staged(_t(tree["params"]), cfg.parallel), specs, mesh)
    batch = {k: torch.from_numpy(v) for k, v in driver._dp_block(
        {k: np.asarray(v) for k, v in tree["batch"].items()}, mesh).items()}
    batch = st.loss_denominators(batch, mesh.group("dp"))
    with mesh_lib.use_mesh(mesh):
        grads, loss = loss_fn(cfg, params, batch)
        _, eval_loss = loss_fn(cfg, params, batch, backward=False)
        plan = st.make_plan(cfg, mesh, specs, params)
        grads, loss = st.reduce_grads(plan, grads, loss)
        grads = sharding.gather_params(grads, specs, mesh)
    return {"loss": loss, "eval_loss": driver._dp_mean(
        {"l": float(eval_loss)}, mesh)["l"], "grads": grads}


def _family_loss(kind: str):
    from megatron_llm_tpu_torch.models import biencoder, encdec

    fn = {"bert": encdec.bert_loss, "t5": encdec.t5_loss,
          "ict": biencoder.retrieval_loss}[kind]
    return lambda cfg, p, mb, rng, det: fn(cfg.model, p, mb, rng, det)


def custom_cp_case(tree: dict, meta: dict) -> dict:
    """A family's custom loss at this world's degrees (cp): step 1's loss
    and whole grads through ``training/step.step_grads`` on the global
    batch ``[1, b, ...]``, then ``pretrain_custom`` over ``tree["data"]``
    (``[N, ...]`` arrays, one sample a row) from the same params: each
    step's loss."""
    from megatron_llm_tpu_torch.models import sharding
    from megatron_llm_tpu_torch.parallel import mesh as mesh_lib
    from megatron_llm_tpu_torch.training import driver
    from megatron_llm_tpu_torch.training import step as st
    from megatron_llm_tpu_torch.utils.tree import tree_map

    cfg = runtime_config(meta)
    loss_fn = _family_loss(meta["kind"])
    params = _t(tree["params"])
    art = driver.setup_train_state(cfg, tree_map(lambda t: t.clone(),
                                                 params), "cpu",
                                   loss_fn=loss_fn)
    batch = {k: torch.from_numpy(np.asarray(v))[None]
             for k, v in tree["batch"].items()}
    with art.in_mesh():
        grads, loss, _ = st.step_grads(cfg, art.state.params, batch, None,
                                       loss_fn=loss_fn, plan=art.plan)
        grads = sharding.gather_params(grads, art.plan.specs, art.mesh)
    data = tree["data"]
    n = len(next(iter(data.values())))

    class Samples:
        def __len__(self):
            return n

        def __getitem__(self, i):
            return {k: v[i] for k, v in data.items()}

    losses = []
    driver.pretrain_custom(cfg, Samples(), params, loss_fn, device="cpu",
                           on_step=lambda it, m, s: losses.append(
                               float(m["loss"])))
    return {"loss": loss, "grads": grads, "losses": np.asarray(losses)}


def moe_layout_case(tree: dict, meta: dict) -> dict:
    """``moe_block`` at this world's degrees (cp, contiguous or zigzag, or
    tp with sequence parallelism) on a whole ``x [b, s, h]``: each rank
    its block of the sequence as the step lays it out, the output gathered
    back in the natural order, the stats (``aux`` summed over cp, the
    rank's share); then one microbatch's loss and whole grads of the MoE
    model through ``training/step.step_grads``."""
    import torch.distributed as dist

    from megatron_llm_tpu_torch.models import moe, sharding
    from megatron_llm_tpu_torch.models.transformer import rope_tables
    from megatron_llm_tpu_torch.parallel import mappings
    from megatron_llm_tpu_torch.parallel import mesh as mesh_lib
    from megatron_llm_tpu_torch.parallel import pipeline as pipe
    from megatron_llm_tpu_torch.parallel.ring_attention import \
        zigzag_indices
    from megatron_llm_tpu_torch.training import step as st
    from megatron_llm_tpu_torch.training.driver import setup_train_state

    cfg = runtime_config(meta)
    mesh = mesh_lib.build_mesh(cfg.parallel)
    cp, tp = mesh.size("cp"), mesh.size("tp")
    x = torch.from_numpy(tree["x"])
    s = x.shape[1]
    order = (zigzag_indices(s, cp) if cfg.model.context_parallel_zigzag
             else np.arange(s))
    n = s // (cp * tp)
    lo = (mesh.index("cp") * tp + mesh.index("tp")) * n
    if cfg.model.sequence_parallel_axis is None:   # the tp ranks hold it all
        n, lo = s // cp, mesh.index("cp") * (s // cp)
    mine = order[lo:lo + n]
    # one layer's MoE leaves: the stacked specs without their layer axis
    layer_specs = sharding.param_specs(cfg.model,
                                       cfg.parallel)["layers"]["mlp"]
    layer = sharding.shard_params(
        _t(tree["layer"]), {k: v[1:] for k, v in layer_specs.items()}, mesh)
    with mesh_lib.use_mesh(mesh), torch.no_grad():
        out, stats = moe.moe_block(cfg.model, layer, x[:, mine].contiguous())
        aux = mappings.all_reduce(stats["aux"].clone(), mesh.group("cp"))
        blocks = [torch.empty_like(out) for _ in range(dist.get_world_size())]
        dist.all_gather(blocks, out.contiguous())
    whole = torch.empty_like(x)
    for r in range(dist.get_world_size()):
        c, t = divmod(r, tp)
        if cfg.model.sequence_parallel_axis is None:
            idx = order[c * (s // cp):(c + 1) * (s // cp)]
        else:
            idx = order[(c * tp + t) * n:(c * tp + t + 1) * n]
        whole[:, idx] = blocks[r]

    art = setup_train_state(cfg, _t(tree["params"]), "cpu")
    batch = {k: torch.from_numpy(np.asarray(v))[None]
             for k, v in tree["batch"].items()}
    with art.in_mesh():
        grads, loss, moe_stats = st.step_grads(
            cfg, art.state.params, batch,
            rope_tables(cfg.model, device="cpu"), plan=art.plan)
        grads = pipe.from_pipeline_params(sharding.gather_params(
            grads, art.plan.specs, art.mesh), cfg.parallel)
    return {"out": whole, "aux": aux, "dropped": stats["dropped"],
            "load": stats["load"], "loss": loss, "grads": grads}


def entry_resume_case(tree: dict, meta: dict) -> dict:
    """An entry's ``main(argv, device="cpu")`` (``meta["argv"]`` saves at
    iteration 2 under ``meta["root"]`` and trains 3), then the checkpoint
    of iteration 3 removed and the run resumed from 2: the straight run's
    logged losses, both runs' iterations, the resumed run's logged steps,
    and whether any rank's resumed params differ from the straight run's
    (1) or none does (0)."""
    import contextlib
    import importlib
    import io
    import re
    import shutil

    import torch.distributed as dist

    from megatron_llm_tpu_torch import checkpointing
    from megatron_llm_tpu_torch.utils.tree import tree_leaves

    entry = importlib.import_module(f"megatron_llm_tpu_torch.{meta['entry']}")
    pattern = r"lm loss: ([0-9.E+-]+) \|"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        straight = entry.main(meta["argv"], device="cpu")
    losses = [float(x) for x in re.findall(pattern, buf.getvalue())]
    dist.barrier()
    if dist.get_rank() == 0:
        shutil.rmtree(os.path.join(meta["root"], "iter_0000003"))
        checkpointing.write_tracker(meta["root"], 2)
    dist.barrier()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        resumed = entry.main(meta["argv"], device="cpu")
    steps = len(re.findall(pattern, buf.getvalue()))
    differ = torch.tensor(int(not all(
        torch.equal(a, b) for a, b in zip(tree_leaves(resumed.params),
                                          tree_leaves(straight.params)))))
    dist.all_reduce(differ, op=dist.ReduceOp.MAX)
    return {"losses": np.asarray(losses), "iters": straight.iteration,
            "resumed_iters": resumed.iteration, "resumed_steps": steps,
            "differ": differ}


# ---------------------------------------------------------------------------
# Sharded serving (tests/test_torch_sharded_serving.py)
# ---------------------------------------------------------------------------


def _serving_model(meta: dict, kv_quant=None):
    from megatron_llm_tpu_torch import config as C

    preset, mkw = meta["model"]
    cfg = getattr(C, preset)(**mkw)
    if kv_quant:
        cfg = dataclasses.replace(cfg, kv_cache_quant=kv_quant).validate()
    return cfg


def _recording(decode, log: list):
    """``decode`` that also logs each step's sampled tokens."""
    def run(*args, **kwargs):
        tok, lp = decode(*args, **kwargs)
        log.append(tok.cpu().tolist())
        return tok, lp
    return run


def _nbytes(tree) -> int:
    from megatron_llm_tpu_torch.utils.tree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def sharded_serving_case(tree: dict, meta: dict) -> dict:
    """Each of ``meta["runs"]`` through ``build_sharded_engine`` on every
    rank (rank 0 serves each batch of request specs in turn, the others
    replay), as JSON: each batch's committed tokens, whether every rank
    sampled the same tokens at every decode step, the decode groups, the
    sanitizer's report, the prefix cache's hits, ``kv_snapshot``'s stages
    and rank 0's resident bytes of params and pool against the whole."""
    import torch.distributed as dist

    from megatron_llm_tpu_torch.config import ParallelConfig
    from megatron_llm_tpu_torch.ops.quant import quantize_params
    from megatron_llm_tpu_torch.serving import EngineConfig
    from megatron_llm_tpu_torch.serving.cluster import build_sharded_engine

    whole = _t(tree["params"])
    results = {}
    for run in meta["runs"]:
        cfg = _serving_model(meta, run.get("kv_quant"))
        params = (quantize_params(whole, run["weights"])
                  if run.get("weights") else whole)
        eng = build_sharded_engine(
            cfg, params, EngineConfig(**run["engine"]),
            ParallelConfig(**run["parallel"]), device="cpu")
        log: list = []
        res: dict = {}
        if dist.get_rank() != 0:
            eng.ops.decode = _recording(eng.ops.decode, log)
            eng.serve()
        else:
            eng._ops.decode = _recording(eng._ops.decode, log)
            eng.start()
            try:
                res["tokens"] = [
                    [list(h.result(120).tokens)
                     for h in eng.submit_many(specs)]
                    for specs in run["batches"]]
                res["groups"] = eng._decode_groups
                res["prefix_hits"] = eng.metrics.snapshot()["prefix_hits"]
                res["stages"] = eng.kv_snapshot().get("stages")
                res["fused"] = [eng._fused_decode, eng._fused_verify]
                pool = eng.slots.pool
                k = pool.k_pool["q"] if isinstance(pool.k_pool, dict) \
                    else pool.k_pool
                res["bytes"] = {
                    "params": _nbytes(eng.params), "whole": _nbytes(params),
                    "pool": k.numel() * k.element_size(),
                    "whole_pool": (cfg.num_layers * pool.n_blocks
                                   * cfg.kv_heads * pool.block_size
                                   * cfg.head_dim * k.element_size())}
            finally:
                eng.shutdown()
            res["leaks"] = eng.sanitizer_report
        logs = [None] * dist.get_world_size()
        dist.all_gather_object(logs, log)
        if dist.get_rank() == 0:
            res["ranks_agree"] = all(g == logs[0] for g in logs)
            res["steps"] = len(logs[0])
            results[run["name"]] = res
    return {"result": np.asarray(json.dumps(results))}


def sharded_forward_case(tree: dict, meta: dict) -> dict:
    """``forward_cached`` (a prefill of ``tokens`` into an empty cache,
    then one step of ``step``) and ``forward_cached_paged`` (``step``
    again over the prefill's rows published into a pool) under each
    serving layout of ``meta["layouts"]``, every rank on its shards: rank
    0's logits, which every rank agrees with (``agree``)."""
    import torch.distributed as dist

    from megatron_llm_tpu_torch.config import ParallelConfig
    from megatron_llm_tpu_torch.models import model as M
    from megatron_llm_tpu_torch.models import sharding
    from megatron_llm_tpu_torch.parallel import mesh as mesh_lib

    cfg = _serving_model(meta)
    whole = _t(tree["params"])
    tokens, step = _t(tree["tokens"]), _t(tree["step"])
    b, s = tokens.shape
    bk = meta["block"]
    out = {}
    for name, par in meta["layouts"].items():
        params, mesh = sharding.shard_for_serving(whole, cfg,
                                                  ParallelConfig(**par))
        with torch.no_grad(), mesh_lib.use_mesh(mesh):
            k, v = M.init_kv_cache(cfg, b, 2 * s, device="cpu")
            pre, k, v = M.forward_cached(cfg, params, tokens, k, v, 0,
                                         empty_cache=True)
            one, _, _ = M.forward_cached(cfg, params, step, k.clone(),
                                         v.clone(), s)
            kp, vp = M.init_kv_pool(cfg, 1 + b * 2 * s // bk, bk,
                                    device="cpu")
            tables = 1 + torch.arange(b * 2 * s // bk).reshape(b, -1)
            for r in range(b):
                M.cache_scatter_blocks(kp, k[:, r:r + 1], tables[r])
                M.cache_scatter_blocks(vp, v[:, r:r + 1], tables[r])
            paged, _, _ = M.forward_cached_paged(
                cfg, params, step, kp, vp, tables,
                torch.full((b,), s, dtype=torch.long))
        got = {"prefill": pre, "step": one, "paged": paged}
        for key, t in got.items():
            whole_t = [torch.empty_like(t) for _ in range(dist.get_world_size())]
            dist.all_gather(whole_t, t.contiguous())
            out[f"{name}/{key}"] = t
            out[f"{name}/{key}_agree"] = np.asarray(
                all(torch.equal(w, t) for w in whole_t))
    return out


def serving_cli_case(tree: dict, meta: dict) -> dict:
    """``run_text_generation_server.main(meta["argv"])`` on every rank:
    rank 0 answers ``meta["body"]`` at PUT /api, then shuts the server
    down gracefully; every rank's ``main`` must return 0."""
    import threading
    import urllib.request

    import torch.distributed as dist

    from megatron_llm_tpu_torch.tools import run_text_generation_server as rtgs

    if dist.get_rank() != 0:
        rc = rtgs.main(meta["argv"])
        return {"rc": rc}
    ready, box = threading.Event(), {}

    def on_ready(server):
        box["server"] = server
        ready.set()

    thread = threading.Thread(target=lambda: box.setdefault(
        "rc", rtgs.main(meta["argv"], on_ready=on_ready)))
    thread.start()
    try:
        assert ready.wait(120), "the server did not start"
        req = urllib.request.Request(
            f"http://127.0.0.1:{box['server'].port}/api",
            data=json.dumps(meta["body"]).encode(), method="PUT",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            status, body = resp.status, json.loads(resp.read())
    finally:
        if "server" in box:
            box["server"].graceful_shutdown(10.0)
        thread.join(60)
    return {"result": np.asarray(json.dumps(
        {"status": status, "text": body["text"], "rc": box.get("rc"),
         "alive": thread.is_alive()}))}


def sharded_lifecycle_case(tree: dict, meta: dict) -> dict:
    """The seam's lifecycle at tp = 2, the world's last job: an engine
    idle for longer than its channel's timeout (shortened here) still
    serves, and its shutdown ends every rank's loop; then a worker whose
    decode raises makes rank 0's request raise with the worker's message,
    and every rank leaves the world (so nothing waits on a dead peer)."""
    import time

    import torch.distributed as dist

    from megatron_llm_tpu_torch.config import ParallelConfig
    from megatron_llm_tpu_torch.serving import EngineConfig
    from megatron_llm_tpu_torch.serving.cluster import sharded

    sharded.HEARTBEAT_S = 0.2
    sharded.CHANNEL_TIMEOUT = datetime.timedelta(seconds=meta["timeout_s"])
    cfg = _serving_model(meta)
    params = _t(tree["params"])
    ec = EngineConfig(**meta["engine"])
    par = ParallelConfig(tensor_parallel=2)
    rank = dist.get_rank()
    res = {}
    eng = sharded.build_sharded_engine(cfg, params, ec, par, device="cpu")
    if rank != 0:
        eng.serve()
        res["worker_returned"] = True
    else:
        eng.start()
        time.sleep(meta["idle_s"])
        h = eng.submit(meta["prompt"], 4, use_eos_stop=False)
        res["idle_tokens"] = list(h.result(60).tokens)
        eng.shutdown()
    returned = [None] * dist.get_world_size()
    dist.all_gather_object(returned, res.get("worker_returned", True))
    res["all_returned"] = all(returned)
    eng = sharded.build_sharded_engine(cfg, params, ec, par, device="cpu")
    if rank != 0:
        def broken(*args, **kwargs):
            raise RuntimeError("injected worker fault")

        eng.ops.decode = broken
        try:
            eng.serve()
        except RuntimeError as e:
            res["worker_raised"] = str(e)
        return None
    eng.start()
    t0 = time.perf_counter()
    try:
        eng.submit(meta["prompt"], 4, use_eos_stop=False).result(60)
        res["fault"] = None
    except RuntimeError as e:
        res["fault"] = str(e)
    res["fault_s"] = time.perf_counter() - t0
    eng.shutdown()
    res["world_left"] = not dist.is_initialized()
    return {"result": np.asarray(json.dumps(res))}


def cluster_serving_case(tree: dict, meta: dict) -> dict:
    """Sharded replicas behind the router in a world of ``1 + R * (n -
    1)`` ranks (``build_cluster(replicas=R, parallel=...)`` on every
    rank): rank 0 routes each of ``meta["batches"]`` and records the
    tokens, each client's stream, the replicas' global ranks and dispatch
    counts and the decode groups; the workers replay.  Then a second
    cluster whose replica 1 worker's decode raises (``meta["fault"]``):
    rank 0 routes ``meta["fault_batch"]`` with streams, the router fails
    replica 1's requests over to replica 0, and every rank returns."""
    import torch.distributed as dist

    from megatron_llm_tpu_torch.config import ParallelConfig
    from megatron_llm_tpu_torch.parallel import mesh as mesh_lib
    from megatron_llm_tpu_torch.serving import EngineConfig, RouterConfig
    from megatron_llm_tpu_torch.serving.cluster import build_cluster

    cfg = _serving_model(meta)
    params = _t(tree["params"])
    ec = EngineConfig(**meta["engine"])
    par = ParallelConfig(**meta["parallel"])
    rank = dist.get_rank()
    res: dict = {}

    def routed(router, specs):
        streams = [[] for _ in specs]
        hs = router.submit_many([
            dict(s, on_token=(lambda i: lambda t: streams[i].append(
                int(t)))(i)) for i, s in enumerate(specs)])
        return [list(h.result(120).tokens) for h in hs], streams

    built = build_cluster(cfg, params, ec, replicas=meta["replicas"],
                          parallel=par, device="cpu")
    if rank != 0:
        res["worker_ranks"] = mesh_lib.global_ranks(built.mesh)
        built.serve()
    else:
        res["mesh_ranks"] = [mesh_lib.global_ranks(r.engine.mesh)
                             for r in built.replicas]
        built.start()
        try:
            res["batches"] = [routed(built, specs)
                              for specs in meta["batches"]]
            snap = built.snapshot()
            res["dispatched"] = [r["dispatched"] for r in snap["replicas"]]
            res["groups"] = [r.engine._decode_groups
                             for r in built.replicas]
        finally:
            built.shutdown()
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, res.get("worker_ranks"))
    res["worker_ranks"] = everyone[1:]

    fault_rank = meta["fault"]
    built = build_cluster(cfg, params, ec, replicas=meta["replicas"],
                          parallel=par, device="cpu",
                          router_config=RouterConfig(probe_interval_s=0.02))
    if rank != 0:
        if rank == fault_rank:
            def broken(*args, **kwargs):
                raise RuntimeError("injected worker fault")

            built.ops.decode = broken
        try:
            built.serve()
        except RuntimeError as e:
            res["worker_raised"] = str(e)
    else:
        built.start()
        try:
            res["fault_batch"] = routed(built, meta["fault_batch"])
            snap = built.snapshot()
            res["fault_snapshot"] = snap["router"]
            res["fault_alive"] = [r["alive"] for r in snap["replicas"]]
        finally:
            built.shutdown()
    raised = [None] * dist.get_world_size()
    dist.all_gather_object(raised, res.get("worker_raised"))
    res["worker_raised"] = raised
    if rank != 0:
        return None
    return {"result": np.asarray(json.dumps(res))}
