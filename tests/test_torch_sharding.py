"""The port's sharding plans against the reference's
(``repro.parallel.sharding``), leaf for leaf: parameter (TP, and FSDP),
optimizer-state, batch and cache specs for every arch at smoke and
published size on (1, 1), (2, 4), (16, 16) and (2, 16, 16) meshes.  The
reference runs on a duck-typed mesh (axis names and sizes), the port on
the same object; parameters are its meta-device trees, shapes JAX's
``eval_shape``.  Then ``zero_extend``, the spec -> DTensor placement
conversion (a dim over ("pod", "data") is ``Shard`` on both mesh dims,
pod-major, checked against DTensor's own offsets over a fake process
group in a subprocess) and the largest rank's local shape."""
import functools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import pytest
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke
from repro.models.api import cache_specs as ref_cache_specs
from repro.models.api import get_model as ref_get_model
from repro.models.api import train_input_specs as ref_train_specs
from repro.parallel import sharding as ref_shd
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.models.api import (cache_specs, param_specs,
                                    train_input_specs)
from repro_torch.parallel import sharding as shd

from test_torch_shapes_mesh import MESHES, DuckMesh

ROOT = Path(__file__).resolve().parents[1]
SIZES = ("smoke", "published")


def _cfgs(arch, size):
    if size == "smoke":
        return get_smoke_config(arch), ref_get_smoke(arch)
    return get_config(arch), ref_get_config(arch)


@functools.lru_cache(maxsize=None)
def _ref_params(arch, size):
    cfg = _cfgs(arch, size)[1]
    model = ref_get_model(cfg)
    return jax.eval_shape(lambda k: model.init(k, cfg),
                          jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_params(arch, size):
    return param_specs(_cfgs(arch, size)[0])


def _ref_flat(tree):
    """{dotted path: spec as a tuple} of a reference spec tree."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {".".join(str(k.key) for k in path): tuple(spec)
            for path, spec in leaves}


def _port_flat(tree):
    return {k: tuple(v) for k, v in shd.flat(tree).items()}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", list_archs())
def test_specs_match_reference(arch, size, mesh):
    cfg, rcfg = _cfgs(arch, size)
    m = DuckMesh(*MESHES[mesh])
    params, rparams = _port_params(arch, size), _ref_params(arch, size)
    # parameters: the config's default, then FSDP on and off
    for fsdp in (None, True, False):
        port = _port_flat(shd.param_pspecs(params, cfg, m, fsdp=fsdp))
        ref = _ref_flat(ref_shd.param_pspecs(rparams, rcfg, m, fsdp=fsdp))
        assert port == ref, (fsdp, set(port.items()) ^ set(ref.items()))
    assert _port_flat(shd.opt_state_pspecs(params, cfg, m)) == \
        _ref_flat(ref_shd.opt_state_pspecs(rparams, rcfg, m))
    # batch: the train inputs at a batch that divides and one that does not
    for batch in (64, 3):
        port = shd.batch_pspecs(train_input_specs(cfg, batch=batch,
                                                  seq_len=8), m)
        ref = ref_shd.batch_pspecs(ref_train_specs(rcfg, batch=batch,
                                                   seq_len=8), m)
        assert {k: tuple(v) for k, v in port.items()} == \
            {k: tuple(v) for k, v in ref.items()}
    # include_model (pure-DP mode) joins the model axis
    port = shd.batch_pspecs(train_input_specs(cfg, batch=512, seq_len=8),
                            m, include_model=True)
    ref = ref_shd.batch_pspecs(ref_train_specs(rcfg, batch=512, seq_len=8),
                               m, include_model=True)
    assert {k: tuple(v) for k, v in port.items()} == \
        {k: tuple(v) for k, v in ref.items()}
    # decode caches
    port = _port_flat(shd.cache_pspecs(
        cache_specs(cfg, batch=32, ctx_len=64), cfg, m))
    ref = _ref_flat(ref_shd.cache_pspecs(
        ref_cache_specs(rcfg, batch=32, ctx_len=64), rcfg, m))
    assert port == ref


def test_meta_trees_have_the_reference_shapes():
    for arch in list_archs():
        port = {k: tuple(v.shape) for k, v in
                shd.flat(_port_params(arch, "published")).items()}
        leaves, _ = jax.tree_util.tree_flatten_with_path(
            _ref_params(arch, "published"))
        ref = {".".join(str(k.key) for k in path): tuple(v.shape)
               for path, v in leaves}
        assert port == ref, arch
        assert all(p.is_meta for p in _port_params(arch,
                                                   "published").parameters())


@pytest.mark.parametrize("mesh", list(MESHES))
def test_zero_extend_matches_reference(mesh):
    m = DuckMesh(*MESHES[mesh])
    cases = [((None, "model"), (64, 128)), ((None, None), (48, 32)),
             (("model", None), (256, 3)), ((None,), (7,)),
             ((None, None, "model"), (4, 96, 32)), ((), (32, 64)),
             ((None, None), (1, 1)), (("model",), (512,))]
    for spec, shape in cases:
        for inc in (False, True):
            port = shd.zero_extend(shd.P(*spec), shape, m, include_model=inc)
            ref = ref_shd.zero_extend(JP(*spec), shape, m,
                                      include_model=inc)
            assert tuple(port) == tuple(ref), (spec, shape, inc)
    # the reference's own case: data of size 1 divides everything
    if mesh == "1x1":
        assert tuple(shd.zero_extend(shd.P(None, "model"), (64, 128),
                                     m)) == ("data", "model")


def test_spec_to_placements():
    from torch.distributed.tensor import Replicate, Shard
    m3 = DuckMesh(*MESHES["2x16x16"])
    m3.mesh_dim_names = m3.axis_names
    pl = shd.placements(shd.P(("pod", "data"), None, "model"), m3)
    assert pl == (Shard(0), Shard(0), Shard(2))
    assert shd.placements(shd.P(None, None), m3) == (Replicate(),) * 3
    assert shd.placements(shd.P(None, ("data", "model")), m3) == \
        (Replicate(), Shard(1), Shard(1))
    with pytest.raises(ValueError):        # not in mesh order
        shd.placements(shd.P(("data", "pod")), m3)
    with pytest.raises(ValueError):        # one axis on two dims
        shd.placements(shd.P("data", "data"), m3)
    tree = {"a": shd.P("model", None), "b": {"c": shd.P(("pod", "data"))}}
    assert shd.named(tree, m3) == {
        "a": (Replicate(), Replicate(), Shard(0)),
        "b": {"c": (Shard(0), Shard(0), Replicate())}}
    # a one-name tuple reads as the name, as JAX normalises it
    assert tuple(shd.P(("data",), None)) == tuple(JP(("data",), None))


def test_local_max_shape_uneven():
    m = DuckMesh(*MESHES["16x16"])
    # yi's 56 kv-head columns of 128 over 16: torch.chunk sizes, ceil
    assert shd.local_max_shape((60, 7168, 7168), shd.P(None, None, "model"),
                               m) == (60, 7168, 448)
    assert shd.local_max_shape((25, 10), shd.P("model", None), m) == (2, 10)
    m3 = DuckMesh(*MESHES["2x16x16"])
    assert shd.local_max_shape((100, 8), shd.P(("pod", "data"), None),
                               m3) == (4, 8)


PLACE = textwrap.dedent("""
    import json, torch, torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor._utils import \\
        compute_local_shape_and_global_offset as local_of
    from repro_torch.parallel import sharding as shd
    out = {}
    for rank in (0, 37, 300, 511):
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=512)
        mesh = DeviceMesh("cpu", torch.arange(512).reshape(2, 16, 16),
                          mesh_dim_names=("pod", "data", "model"))
        spec = shd.P(("pod", "data"), None, "model")
        shape, off = local_of((64, 8, 32), mesh, shd.placements(spec, mesh))
        un, _ = local_of((100, 8, 25), mesh, shd.placements(spec, mesh))
        out[rank] = [list(shape), list(off), list(un)]
        dist.destroy_process_group()
    print(json.dumps(out))
""")


def test_pod_data_shards_are_pod_major():
    """Rank r of the (2, 16, 16) mesh sits at (pod, data, model) =
    (r // 256, r // 16 % 16, r % 16); a dim over ("pod", "data") gives it
    chunk ``pod * 16 + data``, as GSPMD orders a multi-axis dim."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", PLACE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    m3 = DuckMesh(*MESHES["2x16x16"])
    for rank, (shape, off, uneven) in res.items():
        r = int(rank)
        pod, data, model = r // 256, r // 16 % 16, r % 16
        assert shape == [2, 8, 2]
        assert off == [(pod * 16 + data) * 2, 0, model * 2]
        if r == 0:       # the largest rank's share of uneven dims
            assert tuple(uneven) == shd.local_max_shape(
                (100, 8, 25), shd.P(("pod", "data"), None, "model"), m3)
