"""The port's mesh and sharding rules (``parallel.api.filter_spec``,
``parallel.sharding``) against the reference's, leaf for leaf, on
described meshes: ("data", "model") (16, 16) and ("pod", "data",
"model") (2, 16, 16), the reference's production shapes, and a (2, 1)
host mesh.

A described mesh has no devices: the reference's ``filter_spec`` reads
``mesh.axis_names`` and ``mesh.devices.shape`` (``cache_spec_for_leaf``
also ``mesh.devices.size``), so a namespace holding those and an empty
array of the mesh's shape stands in for it. The reference's
``param_specs`` and ``cache_spec_for_leaf`` wrap each spec in a
``NamedSharding``, which needs real devices: each test here patches
``repro.parallel.sharding.NamedSharding`` to return its spec
(``monkeypatch``, inside the test only). Reference trees come from
``jax.eval_shape`` (nothing allocated); the port's models and caches
are built on the ``meta`` device (nothing allocated), so full widths
are cheap on both sides.

The port holds each layer on its own where the reference stacks a leaf
over a leading layer axis (``convert._lm_state``, ``_seq2seq_state``): a
stacked leaf's port counterparts take its spec without its leading
``None``. The port's caches stack every attention (or Mamba) layer in
one tensor where the reference keeps head layers apart and stacks the
body or each hybrid sub-layer: a cache leaf's spec is held on its
trailing (batch and after) dimensions, and its leading ones must be
``None`` on both sides. All comparisons are exact.
"""
import functools
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import model as JM
from repro.parallel import api as JAPI, sharding as JSH
from repro_torch import convert
from repro_torch.configs import registry as preg
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as PM
from repro_torch.models.lm import DecoderLM
from repro_torch.models.seq2seq import EncDecLM
from repro_torch.parallel import api as PAPI, sharding as PSH

ARCHS = jreg.list_archs()
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
          "host2x1": (("data", "model"), (2, 1))}
# every spec the reference's models and rules build (wsc call sites of
# lm.py, seq2seq.py and layers.py; _RULES and _MOE_RULES; the cache rules)
SPECS = [
    (("pod", "data"), None, None),
    (("pod", "data"), None, "model"),
    (("pod", "data"), "model", None, None),
    ("model", ("pod", "data"), None),
    ("data", "model"), ("model", "data"), ("data", None), ("model", None),
    ("model", "data", None), ("model", None, "data"),
    (None, "data", "model"), (None, None, "model", "data"),
    (None, ("pod", "data"), None, "model", None),
    (None, None, "data", None, "model"),
    (None, ("pod", "data"), None, "model"),
    ("pod",), ("data",), (None,), (None, None), (),
    (("data", "pod"), "model"), (("pod", "data", "model"),),
]
DIMS = (1, 2, 3, 4, 6, 16, 24, 32, 48, 64, 7, 256, 1000, 2048)


def described(names, shape):
    """The reference's view of a mesh: names and an empty device array."""
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, object))


@pytest.fixture
def spec_only(monkeypatch):
    """The reference's ``NamedSharding`` in ``parallel.sharding``
    returns its spec (a described mesh holds no devices)."""
    monkeypatch.setattr(JSH, "NamedSharding", lambda mesh, spec: spec)


def _shapes(ndim, rng, n=12):
    return [None] + [tuple(int(d) for d in rng.choice(DIMS, ndim))
                     for _ in range(n)]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_filter_spec_matches(mesh):
    """Every spec the reference uses, against shapes that do and do not
    divide (and ``shape=None``), names the mesh lacks included."""
    names, shape = MESHES[mesh]
    jmesh, pmesh = described(names, shape), PAPI.Mesh(names, shape)
    rng = np.random.default_rng(0)
    n = 0
    for spec in SPECS:
        for sh in _shapes(len(spec), rng):
            want = tuple(JAPI.filter_spec(spec, jmesh, sh))
            assert PAPI.filter_spec(spec, pmesh, sh) == want, (spec, sh)
            n += 1
    assert n == len(SPECS) * 13
    assert PAPI.filter_spec(("data",), None, (4,)) == ()


def test_mesh_context_and_host_mesh(monkeypatch):
    """``mesh_context`` sets and restores the context mesh;
    ``make_host_mesh()`` with no process group is (1, 1) over one
    process, which ``wsc`` and ``filter_spec`` read. The processes that
    share the batch come from the default group alone, and a mesh's
    batch shards must split evenly over them."""
    assert PAPI.get_mesh() is None
    host = make_host_mesh()
    assert (host.axis_names, host.shape, PAPI.processes()) == \
        (("data", "model"), (1, 1), 1)
    assert host.device_mesh is None
    x = torch.ones(4, 2)
    with PAPI.mesh_context(host) as m:
        assert PAPI.get_mesh() is m is host
        assert PAPI.wsc(x, "data", None) is x
        assert PAPI.filter_spec(("data", None), shape=(4, 2)) == ("data",)
        with PAPI.mesh_context(None):
            assert PAPI.get_mesh() is None
        assert PAPI.get_mesh() is host
    assert PAPI.get_mesh() is None
    assert PAPI.BATCH_AXES == JAPI.BATCH_AXES
    assert PAPI.MODEL_AXIS == JAPI.MODEL_AXIS
    assert PAPI.local_shards(PAPI.Mesh(("data", "model"), (3, 1))) == 3
    monkeypatch.setattr(PAPI, "process_group", lambda: (1, 2))
    assert PAPI.processes() == 2
    assert PAPI.local_shards(PAPI.Mesh(("pod", "data"), (2, 2))) == 2
    with pytest.raises(ValueError):
        PAPI.local_shards(PAPI.Mesh(("data", "model"), (3, 1)))


def test_named_gives_placements():
    """``named`` (the ``NamedSharding`` counterpart) gives one DTensor
    placement a mesh dimension: ``Shard(i)`` where the filtered spec's
    entry i names the axis."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = PAPI.Mesh(("pod", "data", "model"), (2, 16, 16))
    assert PAPI.named((("pod", "data"), None, "model"), (64, 3, 32),
                      mesh) == [Shard(0), Shard(0), Shard(2)]
    # 64 does not divide by 2 x 16 x 16: "model" dropped from the tuple;
    # 48 not by 2 x 16 either: "data" too
    assert PAPI.named((("pod", "data", "model"),), (64,), mesh) == \
        [Shard(0), Shard(0), Replicate()]
    assert PAPI.named((("pod", "data", "model"),), (48,), mesh) == \
        [Shard(0), Replicate(), Replicate()]
    assert PAPI.named(("model",), (7,), mesh) == [Replicate()] * 3


def _params(cfg, family):
    """(reference parameter shapes, the port's model on ``meta``)."""
    jshapes = jax.eval_shape(functools.partial(JM.init_params, cfg),
                             jax.random.PRNGKey(0))
    model = (EncDecLM if family == "encdec" else DecoderLM)(cfg, "meta")
    return jshapes, model


def _object(value):
    a = np.empty((), object)
    a[()] = value
    return a


def _reference_specs_by_port_name(cfg, jspecs, jshapes):
    """The reference's spec of every leaf under the port's names: a
    stacked leaf's (under ``blocks``, ``enc_blocks`` or ``dec_blocks``)
    without its leading None, once a layer."""
    def f(path, spec, leaf):
        spec = tuple(spec)
        if path[0].key not in ("blocks", "enc_blocks", "dec_blocks"):
            return _object(spec)
        assert not spec or spec[0] is None, (path, spec)
        out = np.empty(leaf.shape[0], object)
        for j in range(len(out)):
            out[j] = spec[1:]
        return out
    tree = jax.tree_util.tree_map_with_path(f, jspecs, jshapes)
    return {n: v.item() if isinstance(v, np.ndarray) else v
            for n, v in convert._state(cfg, tree).items()}


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("width", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match(arch, width, mesh, spec_only):
    a = jreg.get_config(arch)
    jcfg = a.smoke_model() if width == "smoke" else a.model
    p = preg.get_config(arch)
    pcfg = p.smoke_model() if width == "smoke" else p.model
    names, shape = MESHES[mesh]
    jshapes, model = _params(jcfg, jcfg.family)
    jspecs = JSH.param_specs(jshapes, described(names, shape))
    want = _reference_specs_by_port_name(jcfg, jspecs, jshapes)
    got = PSH.param_specs(model, PAPI.Mesh(names, shape))
    assert set(got) == set(want)
    assert got == want
    # the spec of one leaf, unfiltered, is the rule on its trailing dims
    for n, prm in model.named_parameters():
        raw = PSH.spec_for_leaf(n, prm.ndim)
        assert len(raw) == prm.ndim
        assert PAPI.filter_spec(raw, PAPI.Mesh(names, shape),
                                prm.shape) == got[n]


def _tail(spec, ndim, k):
    """A spec padded to ``ndim`` entries: its last ``k`` and whether the
    leading ones are all None."""
    full = tuple(spec) + (None,) * (ndim - len(spec))
    return full[ndim - k:], all(e is None for e in full[:ndim - k])


@pytest.mark.parametrize("B", [32, 4, 1])
@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match(arch, mesh, B, spec_only):
    """Decode caches at full width (S 256; an encoder-decoder's encoder
    states of 128): batch over (pod, data) where B divides and B > 1,
    else sequence over data; heads or head_dim over model; the SSM's
    batch and heads or channels."""
    jcfg = jreg.get_config(arch).model
    pcfg = preg.get_config(arch).model
    names, shape = MESHES[mesh]
    S, S_enc = 256, 128
    enc = (S_enc,) if jcfg.family == "encdec" else ()
    jshapes = jax.eval_shape(lambda: JM.empty_cache(jcfg, B, S, *enc))
    jspecs = JSH.cache_specs(jshapes, described(names, shape))
    cache = PM.empty_cache(pcfg, B, S, *enc, device="meta")
    got = PSH.cache_specs(cache, PAPI.Mesh(names, shape))
    ref = {}
    for (path, spec), leaf in zip(
            jax.tree_util.tree_flatten_with_path(jspecs)[0],
            jax.tree_util.tree_leaves(jshapes)):
        ref.setdefault(path[-1].key, []).append((tuple(spec), leaf.shape))
    assert set(ref) == set(got)
    for name, t in cache.items():
        k = 3 if name == "conv" else 4
        tail, lead_none = _tail(got[name], t.ndim, k)
        assert lead_none, (name, got[name])
        for spec, jshape in ref[name]:
            assert jshape[-k:] == tuple(t.shape[-k:]), name
            assert _tail(spec, len(jshape), k) == (tail, True), \
                (name, spec, got[name])
