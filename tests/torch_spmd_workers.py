"""The processes of ``test_torch_spmd.py``, ``test_torch_spmd_families.py``,
``test_torch_spmd_serve.py`` and ``test_torch_spmd_serve_families.py``
(no tests here): each function
runs in a rank started by ``torch_dp_workers.run`` (gloo, a ``file://``
rendezvous) or in the test process itself with no group, and returns
what it found. Imports only torch and the port."""
import dataclasses
import itertools
import os

import torch

from repro_torch.configs import registry as preg
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import extra_inputs
from repro_torch.models import layers as PL, model as PM
from repro_torch.optim import adamw
from repro_torch.parallel import api, spmd
from repro_torch.parallel.sharding import cache_specs
from repro_torch.train import loop as PT

B, S, STEPS = 4, 32, 3
OPT = adamw.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
ARCHS = ("qwen2.5-3b", "deepseek-moe-16b")
# the SSM, hybrid and encoder-decoder families' archs
FAMILY_ARCHS = ("mamba2-2.7b", "jamba-v0.1-52b", "seamless-m4t-medium")
NAMES = ("data", "model")
# each case: (arch, changes to its smoke config), shaped so that on the
# (2, 2) mesh every branch of the sharded step that a production cell of
# the ten archs takes runs somewhere
CASES = {
    # GQA (4 q heads over 2 kv heads), q/k/v biases, a tied head on the
    # vocab-parallel embedding
    "qwen2.5-3b": ("qwen2.5-3b", {}),
    # experts and shared experts over "model", the router by hand
    "deepseek-moe-16b": ("deepseek-moe-16b", {}),
    # a tied head, kv heads that divide, no biases
    "gemma-7b": ("gemma-7b", {}),
    # LayerNorm: norm biases are FSDP's ignored parameters
    "stablelm-12b": ("stablelm-12b", {}),
    # q heads that do not divide over "model" (40 over 16 at full width;
    # 5 over 2 here): every rank runs all heads on gathered weights
    "qwen1.5-32b": ("qwen1.5-32b", {"n_heads": 5, "n_kv_heads": 5}),
    # patches added in place to the vocab-parallel embedding
    "internvl2-2b": ("internvl2-2b", {}),
    # a vocabulary that does not divide (92553 at full width; 511 here):
    # the embedding and the logits replicated over "model", with patches
    "internvl2-2b-v511": ("internvl2-2b", {"vocab": 511}),
    # a LayerNorm MoE without shared experts
    "phi3.5-moe-42b-a6.6b": ("phi3.5-moe-42b-a6.6b", {}),
    # the Mamba mixer over "model" (16 SSM heads, 8 a rank; B and C of
    # its one group on both), no FFN, a tied head on the vocab-parallel
    # embedding
    "mamba2-2.7b": ("mamba2-2.7b", {}),
    # one super-block of 8 layers: attention at index 4, Mamba elsewhere,
    # MoE on the odd sub-layers, remat over the whole super-block
    "jamba-v0.1-52b": ("jamba-v0.1-52b", {}),
    # the encoder-decoder: non-causal encoder and causal decoder self
    # attention and cross attention, heads over "model", GELU MLPs,
    # LayerNorms, frames split like tokens
    "seamless-m4t-medium": ("seamless-m4t-medium", {}),
    # its vocabulary that does not divide (256206 at full width; 511
    # here): the embedding and the untied head replicated over "model"
    "seamless-m4t-medium-v511": ("seamless-m4t-medium", {"vocab": 511}),
}
# the cases of the dense and MoE LM archs, and of the other families
LM_CASES = tuple(c for c in CASES if CASES[c][0] not in FAMILY_ARCHS)
FAMILY_CASES = tuple(c for c in CASES if CASES[c][0] in FAMILY_ARCHS)
# the cases of a B = 1 decode over a kv cache whose sequence lies over
# "data": jamba's super-block (2 kv heads, one a model rank), and with one
# kv head, which does not divide over "model", so that the cache's
# head_dim columns lie over "model" too (jamba-v0.1-52b's 8 kv heads over
# 16 at long_500k)
SERVE_CASES = {"jamba-v0.1-52b-kv1": ("jamba-v0.1-52b", {"n_kv_heads": 1})}
SEQ_CASES = ("jamba-v0.1-52b", "jamba-v0.1-52b-kv1")


def smoke(case: str, registry=preg):
    """The case's smoke config (``registry``: the port's, or the
    reference's for the same case), with the per-shard dispatch for an
    MoE: the routing the sharded step does on each data shard."""
    arch, changes = {**CASES, **SERVE_CASES}[case]
    cfg = registry.get_config(arch).smoke_model()
    return dataclasses.replace(cfg, opt_moe_local_dispatch=bool(
        cfg.n_experts), **changes)


def batch(case: str, step: int):
    """Step ``step``'s batch of ``SyntheticLM`` (B, S) on the CPU, with a
    vision arch's patches as the launcher draws them."""
    cfg = smoke(case)
    extra = extra_inputs(cfg, B, S, "cpu")
    return SyntheticLM(DataConfig(cfg.vocab, S, B)).torch_batch(
        step, "cpu", extra(step) if extra else None)


def initial(case: str, init_dir=None):
    """The whole model of ``case`` on the CPU: seed 0 of the port, or the
    weights saved as ``init_dir/<case>.init.pt`` (the reference's seed 0
    carried over)."""
    model = PM.init_params(smoke(case), 0, "cpu")
    if init_dir is not None:
        state = torch.load(os.path.join(init_dir, f"{case}.init.pt"))
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(state[n])
    return model


def reference_routes(init_dir, case: str):
    """The reference's routing of every MoE call of its sharded steps, in
    call order: (sorted experts (dp, T/dp, K), probabilities (dp, T/dp,
    E)) a call, shard g of the batch at [g]."""
    return torch.load(os.path.join(init_dir, f"{case}.ref.pt"))["routes"]


def _route_log(log, follow=None):
    """Patch ``PL.moe_route`` to log each call's sorted experts and its
    router probabilities; with ``follow``, its i-th call chooses the
    experts ``follow(i)`` instead (``torch_parity.follow_reference``'s
    rule: the gates stay its own probabilities of them). Returns the
    original."""
    orig = PL.moe_route
    calls = itertools.count()

    def route(p, xf, cfg, C, router=None):
        r = orig(p, xf, cfg, C, router)
        if follow is not None:
            r = PL.moe_assign(r.probs, follow(next(calls)).to(
                r.eidx.device, torch.long), C)
        log.append((r.eidx.sort(dim=1).values.clone(),
                    r.probs.detach().clone()))
        return r
    PL.moe_route = route
    return orig


def one_process(case: str, shape=(2, 2), init_dir=None, follow=False):
    """``STEPS`` steps of ``make_step`` in one process under a described
    mesh of ``shape`` (the per-shard dispatch sees its batch shards), from
    :func:`initial`: losses, norms, every routing call and the
    parameters. With ``follow`` its routing call 2k + g (shard g of
    layer call k) chooses the reference's experts of call k, shard g."""
    cfg = smoke(case)
    model = initial(case, init_dir).requires_grad_(True)
    state = adamw.init(dict(model.named_parameters()))
    step = PT.make_step(cfg, OPT, PT.TrainConfig())
    log, losses, norms = [], [], []
    if follow:
        routes = reference_routes(init_dir, case)
        orig = _route_log(log, lambda i: routes[i // 2][0][i % 2])
    else:
        orig = _route_log(log)
    try:
        with api.mesh_context(api.Mesh(NAMES, shape)):
            for s in range(STEPS):
                stats = step(model, state, batch(case, s))
                losses.append(stats["loss"].clone())
                norms.append(stats["grad_norm"].clone())
    finally:
        PL.moe_route = orig
    return {"losses": losses, "norms": norms, "routes": log,
            "params": {n: p.detach().clone()
                       for n, p in model.named_parameters()}}


def sharded(rank, world, case: str, shape, init_dir=None, follow=False):
    """``STEPS`` steps of ``spmd.make_step`` on a mesh of ``shape`` over
    the group's ranks, from the whole model of :func:`initial` cut by
    ``shard_state``: losses, norms, routing calls, this rank's shards
    of the parameters, the collectives of each step
    (``spmd.Recorder``), and the names of the weights each module reads
    through a view (under "views", by module name). With ``follow`` its
    routing call k chooses the reference's experts of call k for this
    rank's batch shard."""
    cfg = smoke(case)
    mesh = make_mesh(NAMES, shape)
    model = spmd.build(cfg, mesh, "cpu", spmd.shard_state(
        initial(case, init_dir), mesh, rank))
    state = adamw.init(model.local_params())
    step = spmd.make_step(OPT)
    log, losses, norms, logs = [], [], [], []
    if follow:
        routes, g = reference_routes(init_dir, case), model.place.batch_shard
        orig = _route_log(log, lambda i: routes[i][0][g])
    else:
        orig = _route_log(log)
    try:
        for s in range(STEPS):
            rec = spmd.Recorder()
            with rec:
                stats = step(model, state, spmd.rank_rows(
                    batch(case, s), model.place))
            logs.append(rec.log)
            losses.append(stats["loss"].clone())
            norms.append(stats["grad_norm"].clone())
    finally:
        PL.moe_route = orig
    return {"losses": losses, "norms": norms, "routes": log,
            "collectives": logs, "at": model.place.at,
            "views": {n: sorted(m.views) for n, m in model.named_modules()
                      if isinstance(m, spmd._Viewed)},
            "params": {n: p.detach().clone()
                       for n, p in model.local_params().items()}}


def today(arch: str):
    """``one_process`` without a mesh: today's step, for world 1."""
    cfg = dataclasses.replace(smoke(arch), opt_moe_local_dispatch=False)
    model = PM.init_params(cfg, 0, "cpu").requires_grad_(True)
    state = adamw.init(dict(model.named_parameters()))
    step = PT.make_step(cfg, OPT, PT.TrainConfig())
    losses = [step(model, state, batch(arch, s))["loss"].clone()
              for s in range(STEPS)]
    return {"losses": losses, "params": {
        n: p.detach().clone() for n, p in model.named_parameters()}}


def world(rank, world_size, shape, init_dir, cases=LM_CASES):
    """Each of ``cases``, sharded on ``shape`` from the weights in
    ``init_dir``; an MoE's again choosing the reference's experts (under
    "followed")."""
    out = {}
    for c in cases:
        out[c] = sharded(rank, world_size, c, shape, init_dir)
        if smoke(c).n_experts:
            out[c]["followed"] = sharded(rank, world_size, c, shape,
                                         init_dir, follow=True)
    return out


def world_one(rank, world_size, archs=ARCHS):
    """Each of ``archs`` sharded on (1, 1), beside today's step in the
    same process (its result under "today")."""
    return {"sharded": {a: sharded(rank, world_size, a, (1, 1))
                        for a in archs},
            "today": {a: today(a) for a in archs}}


# --- serving: the sharded prefill and decode steps -------------------------

# a prompt of S tokens into caches of S + SERVE_STEPS positions, then
# SERVE_STEPS teacher-forced decode steps; the SSM, hybrid and
# encoder-decoder cases take FAMILY_STEPS steps of the reference's greedy
# tokens
SERVE_STEPS = 2
CACHE_LEN = S + SERVE_STEPS
FAMILY_STEPS = 3


def serve_inputs(case: str):
    """The prompt batch (step 0's tokens (B, S), a vision arch's patches)
    and the decode tokens (B, SERVE_STEPS): step 1's first tokens."""
    b0, b1 = batch(case, 0), batch(case, 1)
    prompt = {k: v for k, v in b0.items() if k != "labels"}
    return prompt, b1["tokens"][:, :SERVE_STEPS]


def _clone(caches):
    return {n: t.clone() for n, t in caches.items()}


def serve_one_process(case: str, shape=(2, 2), init_dir=None, follow=None,
                      tokens=None):
    """``model.prefill_fn`` into CACHE_LEN positions, then SERVE_STEPS
    ``decode_fn`` steps, in one process under a described mesh of
    ``shape`` (an MoE's prefill dispatches per batch shard, its decode
    over the whole batch, as the reference's), from :func:`initial`: the
    logits of each step, the caches after the prefill and after the last
    step, and every routing call. ``follow`` (a list of experts (T, K),
    one a routing call in call order) makes call i choose ``follow[i]``.
    ``tokens`` (B, n): the decode steps' tokens in place of
    :func:`serve_inputs`' (n steps, the cache n longer than the
    prompt)."""
    cfg = smoke(case)
    model = initial(case, init_dir)
    prompt, teach = serve_inputs(case)
    tokens = teach if tokens is None else tokens
    log = []
    orig = _route_log(log, None if follow is None else follow.__getitem__)
    try:
        with api.mesh_context(api.Mesh(NAMES, shape)), torch.no_grad():
            logits, caches = PM.prefill_fn(cfg, model, prompt,
                                           cache_len=S + tokens.shape[1])
            out = {"logits": [logits], "prefill_caches": _clone(caches)}
            for i in range(tokens.shape[1]):
                logits, caches = PM.decode_fn(cfg, model, caches,
                                              tokens[:, i:i + 1], S + i)
                out["logits"].append(logits)
    finally:
        PL.moe_route = orig
    out.update(caches=caches, routes=log)
    return out


def serve_sharded(rank, world, case: str, shape, init_dir=None,
                  follow=None, tokens=None):
    """The same through the sharded model's ``prefill`` and
    ``decode_step`` on a mesh of ``shape`` over the group's ranks, from
    the whole model of :func:`initial` cut by ``shard_state``, on this
    rank's rows: its blocks of each step's logits and of the caches, its
    routing calls, the collectives of each step (``spmd.Recorder``) and
    its mesh position. ``follow(k, g)``: the experts routing call k of
    batch shard g chooses; ``tokens`` as :func:`serve_one_process`'s."""
    cfg = smoke(case)
    mesh = make_mesh(NAMES, shape)
    model = spmd.build(cfg, mesh, "cpu", spmd.shard_state(
        initial(case, init_dir), mesh, rank))
    prompt, teach = serve_inputs(case)
    rows = spmd.rank_rows(dict(prompt, next=teach if tokens is None
                               else tokens), model.place)
    tokens = rows.pop("next")
    log, logs = [], []
    g = model.place.batch_shard
    orig = _route_log(log, None if follow is None else
                      (lambda k: follow(k, g)))
    try:
        rec = spmd.Recorder()
        with rec:
            logits, caches = model.prefill(rows,
                                           cache_len=S + tokens.shape[1])
        logs.append(rec.log)
        out = {"logits": [logits], "prefill_caches": _clone(caches)}
        for i in range(tokens.shape[1]):
            rec = spmd.Recorder()
            with rec:
                logits, caches = model.decode_step(
                    caches, tokens[:, i:i + 1], S + i)
            logs.append(rec.log)
            out["logits"].append(logits)
    finally:
        PL.moe_route = orig
    out.update(caches=caches, routes=log, collectives=logs,
               at=model.place.at)
    return out


def serve_world(rank, world_size, shape, follows, cases=LM_CASES):
    """Each of ``cases`` served sharded on ``shape`` from the reference's
    weights; an MoE's again choosing the reference's experts (under
    "followed"; ``follows[case][k][g]``: call k's experts of shard g).
    ``follows["tokens"][case]``, where given: the decode steps' tokens."""
    init_dir = follows["init_dir"]
    out = {}
    for c in cases:
        tokens = follows.get("tokens", {}).get(c)
        out[c] = serve_sharded(rank, world_size, c, shape, init_dir,
                               tokens=tokens)
        if smoke(c).n_experts:
            want = follows[c]
            out[c]["followed"] = serve_sharded(
                rank, world_size, c, shape, init_dir,
                follow=lambda k, g: want[k][g], tokens=tokens)
    return out


def serve_world_one(rank, world_size, archs=ARCHS):
    """Each of ``archs`` served sharded on (1, 1) from seed 0, beside the
    plain prefill and decode of the same weights in the same process
    (under "plain"), both without a mesh."""
    out = {"sharded": {}, "plain": {}}
    for arch in archs:
        out["sharded"][arch] = serve_sharded(rank, world_size, arch, (1, 1))
        cfg = dataclasses.replace(smoke(arch), opt_moe_local_dispatch=False)
        model = PM.init_params(cfg, 0, "cpu")
        prompt, tokens = serve_inputs(arch)
        with torch.no_grad():
            logits, caches = PM.prefill_fn(cfg, model, prompt,
                                           cache_len=CACHE_LEN)
            plain = {"logits": [logits], "prefill_caches": _clone(caches)}
            for i in range(SERVE_STEPS):
                logits, caches = PM.decode_fn(cfg, model, caches,
                                              tokens[:, i:i + 1], S + i)
                plain["logits"].append(logits)
        plain["caches"] = caches
        out["plain"][arch] = plain
    return out


# a B = 1 decode: the first row of the prompt, SEQ_STEPS greedy steps, in a
# cache of SEQ_LEN positions, which splits over "data"
SEQ_STEPS, SEQ_LEN = 3, 2 * S


def seq_plain(case: str):
    """``case`` from seed 0 at B = 1 in one process with no group: the
    plain prefill of :func:`serve_inputs`' first row into a cache of
    SEQ_LEN positions, then SEQ_STEPS greedy ``decode_fn`` steps: the
    logits, the tokens (1, 1) a step, the caches after the prefill and
    after the last step, and the decode steps' routing calls."""
    cfg = dataclasses.replace(smoke(case), opt_moe_local_dispatch=False)
    model = PM.init_params(cfg, 0, "cpu")
    prompt, _ = serve_inputs(case)
    prompt = {k: v[:1] for k, v in prompt.items()}
    log = []
    orig = _route_log(log)
    try:
        with torch.no_grad():
            logits, caches = PM.prefill_fn(cfg, model, prompt,
                                           cache_len=SEQ_LEN)
            out = {"logits": [], "tokens": [],
                   "prefill_caches": _clone(caches)}
            del log[:]
            for i in range(SEQ_STEPS):
                tok = logits.argmax(-1)
                out["tokens"].append(tok)
                logits, caches = PM.decode_fn(cfg, model, caches, tok, S + i)
                out["logits"].append(logits)
    finally:
        PL.moe_route = orig
    out.update(caches=caches, routes=log)
    return out


def serve_seq_split(rank, world_size, shape, plains):
    """Each case of ``plains`` (``case``: its :func:`seq_plain`) from seed
    0: the plain run's tokens through ``decode_step`` on a mesh of
    ``shape``, from its prefill's caches cut to this rank's block under
    ``cache_specs`` (rows whole, the kv cache's sequence over "data"),
    as ``shard_state`` cuts the weights: this rank's blocks of the
    logits and caches, each step's collectives, its routing calls and
    its mesh position; and again with each routing call choosing the
    plain run's experts (under "followed")."""
    out = {}
    for case, plain in plains.items():
        cfg = dataclasses.replace(smoke(case), opt_moe_local_dispatch=False)
        mesh = make_mesh(NAMES, shape)
        model = spmd.build(cfg, mesh, "cpu", spmd.shard_state(
            PM.init_params(cfg, 0, "cpu"), mesh, rank))
        specs = cache_specs(plain["prefill_caches"], mesh)
        for side, follow in ((case, None),
                             ("followed", lambda i: plain["routes"][i][0])):
            mine = {n: spmd.cut(t, specs[n], mesh, model.place.at).clone()
                    for n, t in plain["prefill_caches"].items()}
            got = {"logits": [], "collectives": [], "routes": [],
                   "at": model.place.at}
            orig = _route_log(got["routes"], follow)
            try:
                for i, tok in enumerate(plain["tokens"]):
                    rec = spmd.Recorder()
                    with rec:
                        logits, mine = model.decode_step(mine, tok, S + i,
                                                         specs)
                    got["logits"].append(logits)
                    got["collectives"].append(rec.log)
            finally:
                PL.moe_route = orig
            got["caches"] = mine
            if side == case:
                out[case] = got
            else:
                out[case]["followed"] = got
    return out
