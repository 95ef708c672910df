"""The port's shape set and mesh axis conventions against the reference's
(``repro.configs.shapes``, ``repro.parallel.mesh``): ``SHAPES`` and
``applicable_shapes`` for every arch, ``MeshSpec``, and ``data_axes`` /
``model_axis`` / ``axis_size`` on duck-typed meshes (axis names and a
name -> size mapping, no process group) at (1, 1), (2, 4), (16, 16) and
(2, 16, 16)."""
from dataclasses import asdict

import pytest

from repro.configs import get_config as ref_get_config
from repro.configs.shapes import (SHAPES as REF_SHAPES,
                                  applicable_shapes as ref_applicable)
from repro.parallel import mesh as ref_mesh
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable_shapes
from repro_torch.parallel import mesh as port_mesh

MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


class DuckMesh:
    """What the plans read of a mesh: axis names and their sizes."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


def test_shapes_table_matches_reference():
    assert list(SHAPES) == list(REF_SHAPES)
    for name, spec in SHAPES.items():
        assert isinstance(spec, ShapeSpec)
        assert asdict(spec) == asdict(REF_SHAPES[name])


@pytest.mark.parametrize("arch", list_archs())
def test_applicable_shapes_match_reference(arch):
    port = [s.name for s in applicable_shapes(get_config(arch))]
    ref = [s.name for s in ref_applicable(ref_get_config(arch))]
    assert port == ref
    assert port[:3] == ["train_4k", "prefill_32k", "decode_32k"]


def test_mesh_specs_match_reference():
    for name in ("SINGLE_POD", "MULTI_POD"):
        p, r = getattr(port_mesh, name), getattr(ref_mesh, name)
        assert (p.shape, p.axes, p.n_devices) == (r.shape, r.axes,
                                                  r.n_devices)
    assert port_mesh.SINGLE_POD.n_devices == 256
    assert port_mesh.MULTI_POD.n_devices == 512


@pytest.mark.parametrize("mesh", list(MESHES))
def test_axis_helpers_match_reference(mesh):
    m = DuckMesh(*MESHES[mesh])
    assert port_mesh.data_axes(m) == ref_mesh.data_axes(m)
    assert port_mesh.model_axis(m) == ref_mesh.model_axis(m)
    for axes in (None, "data", "model", ("data",), ("data", "model"),
                 port_mesh.data_axes(m)):
        assert port_mesh.axis_size(m, axes) == ref_mesh.axis_size(m, axes)
    if "pod" in m.axis_names:
        assert port_mesh.data_axes(m) == ("pod", "data")
        assert port_mesh.axis_size(m, ("pod", "data")) == 32
