"""The port's sharding tables and meshes (``repro_torch.distributed.
sharding``, ``launch/mesh.py``, ``launch/dryrun.py``, every model's
``param_specs`` / ``param_logical``, the cache logicals, ``Cell.arg_specs``
/ ``arg_logical``) against the JAX reference, on the CPU.

The production meshes are ``DeviceMesh``es under the ``fake`` backend
(512 ranks, no data); the reference's ``install_rules`` reads only a
mesh's ``axis_names`` and ``shape``, so it gets a stub.  The blocks that
DTensor placements give each rank are held against the reference's
``NamedSharding.devices_indices_map`` from a subprocess with 8 host
devices (XLA fixes the device count at its first use), the port's side
computed rank by rank under a fake group of 8.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.distributed.tensor.placement_types import _StridedShard
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs import all_cells as jax_all_cells
from repro.configs import get_config as jax_config
from repro.distributed import sharding as jshd
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.models import transformer as jtr
from repro_torch.configs import ARCHS, all_cells, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun, mesh, steps
from repro_torch.models import transformer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = all_cells()[0]
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def canon(tree):
    """A logical tree comparable across the packages: dicts by key,
    NamedTuples as (name, fields), ``PartitionSpec``s and specs as
    tuples."""
    if isinstance(tree, dict):
        return {k: canon(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (type(tree).__name__,
                tuple(canon(getattr(tree, f)) for f in tree._fields))
    if isinstance(tree, P):
        return tuple(tree)
    if isinstance(tree, tuple) and not shd.is_spec(tree):
        return tuple(canon(v) for v in tree)
    return tree


def dtype_name(dt) -> str:
    if isinstance(dt, torch.dtype):
        return str(dt).replace("torch.", "")
    return np.dtype(dt).name


def flat_specs(tree, prefix=""):
    """path -> (shape, dtype name) of a tree of ``ShapeDtypeStruct``s or
    ``Spec``s (dicts, NamedTuples, tuples)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_specs(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields") \
            and not hasattr(tree, "dtype"):
        out = {}
        for f in tree._fields:
            out.update(flat_specs(getattr(tree, f), f"{prefix}/.{f}"))
        return out
    if isinstance(tree, tuple) and not hasattr(tree, "dtype"):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat_specs(v, f"{prefix}/{i}"))
        return out
    return {prefix: (tuple(tree.shape), dtype_name(tree.dtype))}


class StubMesh:
    """What the reference's ``install_rules`` reads of a mesh."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.shape = dict(zip(names, shape))


# ---------------------------------------------------------------------------
# the logical rules (the reference's TestLogicalRules)
# ---------------------------------------------------------------------------
class TestLogicalRules:
    def teardown_method(self):
        shd.clear_rules()
        jshd.clear_rules()

    def test_no_rules_noop(self):
        shd.clear_rules()
        x = torch.ones(4, 4)
        assert shd.hint(x, "dp", None) is x

    def test_logical_resolution(self):
        shd.set_rules(dp=("pod", "data"), tp="model")
        jshd.set_rules(dp=("pod", "data"), tp="model")
        assert shd.logical("dp", None, "tp") == \
            (("pod", "data"), None, "model") == \
            tuple(jshd.logical("dp", None, "tp"))
        assert shd.logical(None, "missing") == (None, None) == \
            tuple(jshd.logical(None, "missing"))
        # PartitionSpec's normalisation: one axis is its name, none None
        shd.set_rules(dp=("data",), tp=())
        assert shd.logical("dp", "tp") == ("data", None) == tuple(P(("data",),
                                                                    ()))

    def test_rules_cleared(self):
        shd.set_rules(dp="data")
        shd.clear_rules()
        assert shd.get_rules() == {}
        assert shd.active_mesh() is None

    def test_hints_redistribute_a_dtensor(self):
        """A plain tensor passes ``hint`` / ``shard_hint`` unchanged; a
        DTensor is redistributed to the hinted spec on its own mesh; the
        mesh entry points default to CUDA and raise without it."""
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
        try:
            m = mesh.make_host_mesh(device="cpu")
            shd.set_rules(mesh=m, dp="data", tp="model")
            x = torch.arange(12.0).reshape(4, 3)
            assert shd.hint(x, "dp", "tp") is x
            d = shd.distribute(x, m, (None, None))
            assert all(p.is_replicate() for p in d.placements)
            h = shd.hint(d, "dp", None)
            assert h.placements[0].is_shard(0) and \
                h.placements[1].is_replicate()
            assert torch.equal(shd.gathered(h), x)
            with pytest.raises(RuntimeError, match="cuda"):
                mesh.make_host_mesh()
        finally:
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# parameter, cache and argument tables
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_param_tables_match_reference(arch):
    """``param_specs`` name by name with shapes and dtypes, and
    ``param_logical``, of each full config equal the reference's."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    mod, jmod = steps.model_module(cfg), jsteps.model_module(jcfg)
    got, want = flat_specs(mod.param_specs(cfg)), flat_specs(
        jmod.param_specs(jcfg))
    assert got == want
    assert mod.param_logical(cfg) == jmod.param_logical(jcfg)
    assert set(mod.param_logical(cfg)) == set(mod.param_defs(cfg))


def test_cache_logicals_match_reference():
    assert transformer.cache_logical() == jtr.cache_logical()
    assert transformer.sliding_cache_logical() == jtr.sliding_cache_logical()


def test_cells_are_the_reference_cells():
    assert CELLS == jax_all_cells()[0] and len(CELLS) == 37


@pytest.mark.parametrize("arch,shape", CELLS)
def test_arg_logical_matches_reference(arch, shape):
    """``Cell.arg_logical``: the same tree as the reference's cell."""
    got = steps.build_cell(arch, shape).arg_logical
    want = jsteps.build_cell(arch, shape).arg_logical
    assert canon(got) == canon(want)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_arg_specs_match_reference(arch, shape):
    """``Cell.arg_specs``: every leaf's shape and dtype, by path."""
    got = flat_specs(steps.build_cell(arch, shape).arg_specs)
    want = flat_specs(jsteps.build_cell(arch, shape).arg_specs)
    assert got == want


# ---------------------------------------------------------------------------
# the production meshes under a fake group of 512 ranks
# ---------------------------------------------------------------------------
class TestProductionMeshes:
    @pytest.fixture(scope="class")
    def meshes(self):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=512)
        try:
            yield {name: mesh.make_production_mesh(name == "multi", "cpu")
                   for name in MESHES}
        finally:
            shd.clear_rules()
            dist.destroy_process_group()

    def teardown_method(self):
        shd.clear_rules()
        jshd.clear_rules()

    def test_production_mesh_shapes(self, meshes):
        for name, (shape, names) in MESHES.items():
            m = meshes[name]
            assert tuple(m.shape) == shape and m.mesh_dim_names == names
            assert shd.mesh_shape(m) == dict(zip(names, shape))
        assert shd.data_axes(meshes["multi"]) == ("pod", "data")
        assert shd.data_parallel_size(meshes["multi"]) == 32
        for name, (shape, names) in MESHES.items():
            m, stub = meshes[name], StubMesh(shape, names)
            for n, axis in ((48, "model"), (40, "model"), (2, "pod"),
                            (32, "data")):
                assert shd.divisible(n, m, axis) == \
                    jshd.divisible(n, stub, axis)
                assert shd.axis_size(m, axis) == jshd.axis_size(stub, axis)
            tree = shd.tree_shardings(m, {"w": ("data", None), "b": ()})
            assert tree["w"].spec == ("data", None) and tree["b"].spec == ()
            assert tree["w"].placements[names.index("data")].is_shard(0)

    @pytest.mark.parametrize("arch,shape", CELLS)
    def test_install_rules_matches_reference(self, meshes, arch, shape):
        """The rule dict (and the rules installed) of every cell on both
        production meshes."""
        cell = steps.build_cell(arch, shape)
        jcfg = jax_config(arch)
        for name, (mshape, names) in MESHES.items():
            got = mesh.install_rules(meshes[name], cell.cfg,
                                     cell.shape.global_batch,
                                     kind=cell.shape.kind)
            want = jmesh.install_rules(StubMesh(mshape, names), jcfg,
                                       cell.shape.global_batch,
                                       kind=cell.shape.kind)
            assert got == want, name
            assert shd.get_rules() == jshd.get_rules()
            assert shd.active_mesh() is meshes[name]
            jshd.clear_rules()

    def test_batch_spec_matches_reference(self, meshes):
        for name, (mshape, names) in MESHES.items():
            for b in (1, 2, 16, 24, 32, 256, 384):
                assert shd.batch_spec(meshes[name], b) == tuple(
                    jshd.batch_spec(StubMesh(mshape, names), b)), (name, b)

    def test_to_shardings_uneven_dim_replicated(self, meshes):
        """The port's side of the reference's
        ``test_uneven_dim_replicated_not_errored``: an axis that does not
        divide its dim (a 1001-class head over a 4-way axis) is dropped."""
        m = mesh.mesh_over((2, 4), ("data", "model"), "cpu")
        shd.set_rules(mesh=m, dp="data", tp="model")
        specs = {"w": steps.Spec((10, 1001), np.float32)}
        sh = dryrun._to_shardings(m, {"w": ("dp", "tp")}, specs)
        assert sh["w"].spec == ("data", None)
        assert [str(p) for p in sh["w"].placements] == \
            [str(p) for p in shd.placements(m, ("data", None))]
        assert dryrun._axis_prod(m, ("data", "model")) == 8

    def test_fit_replicates_and_distribute_moves_nothing(self, meshes):
        """``fit`` (the rule ``_to_shardings`` and ``replace_mesh`` share)
        replicates a non-dividing entry and one past the tensor's dims;
        ``distribute`` refuses a tensor off the mesh's device type rather
        than copying it there."""
        m = mesh.mesh_over((2, 4), ("data", "model"), "cpu")
        assert shd.fit(m, ("data", ("data", "model"), "model"),
                       (6, 12)) == ("data", None, None)
        assert shd.fit(m, (("model", "data"), None), (16, 3)) == \
            (("model", "data"), None)
        assert shd.fit(m, ("data", "model"), (3, 8)) == (None, "model")
        with pytest.raises(ValueError, match="meta tensor for a cpu mesh"):
            shd.distribute(torch.zeros(4, 4, device="meta"), m, (None, None))

    def test_refused_specs_are_the_reversed_major_orders(self, meshes):
        """Every leaf of every cell places on both meshes.  The multi-axis
        dims against mesh order, which ``placements`` once refused
        (dense-LM decode's ``tp = ("model", "data")`` and the 1T MoE's
        ``fsdp = ("data", "pod")`` on the multi-pod mesh), are exactly the
        ones that now take ``_StridedShard`` placements."""
        strided = set()
        for name, m in meshes.items():
            for arch, shape in CELLS:
                cell = steps.build_cell(arch, shape)
                mesh.install_rules(m, cell.cfg, cell.shape.global_batch,
                                   kind=cell.shape.kind)
                tree = dryrun._to_shardings(m, cell.arg_logical,
                                            cell.arg_specs)
                for sharding in sharding_leaves(tree):
                    if any(isinstance(p, _StridedShard)
                           for p in sharding.placements):
                        strided.update(a for a in sharding.spec
                                       if isinstance(a, tuple))
                shd.clear_rules()
        assert strided == {("model", "data"), ("data", "pod")}

def sharding_leaves(tree):
    """The ``NamedSharding`` leaves of a tree of dicts and tuples."""
    if isinstance(tree, shd.NamedSharding):
        return [tree]
    vals = tree.values() if isinstance(tree, dict) else tree
    return [x for v in vals for x in sharding_leaves(v)]


# ---------------------------------------------------------------------------
# placements against the reference's device index maps
# ---------------------------------------------------------------------------
# (mesh shape, axis names, spec) on 8 devices, a (8, 12, 16) array
PLACE_MESHES = {"2x4": ((2, 4), ("data", "model")),
                "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
                "2x1x4": ((2, 1, 4), ("pod", "data", "model"))}
PLACE_SHAPE = (8, 12, 16)
PLACE_CASES = [
    ("2x4", ("data", None, "model")),
    ("2x4", (None, "model", "data")),
    ("2x4", (("data", "model"), None, None)),
    ("2x4", (None, None, ("data", "model"))),
    ("2x4", (None, None, None)),
    ("2x2x2", (("pod", "data"), "model", None)),
    ("2x2x2", (None, ("pod", "model"), "data")),
    ("2x2x2", ("data", None, ("pod", "model"))),
    ("2x1x4", (("data", "pod"), None, "model")),
    ("2x1x4", (("model", "data"), "pod", None)),
]
# dims sharded over axes against mesh order (``_StridedShard``)
REFUSED_CASES = [("2x4", (("model", "data"), None, None)),
                 ("2x2x2", (None, ("data", "pod"), None)),
                 ("2x2x2", (("model", "pod"), None, None)),
                 ("2x2x2", (("model", "data", "pod"), None, None)),
                 ("2x2x2", (("data", "pod"), ("model",), None))]

_REFERENCE_MAPS = r"""
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
meshes = {meshes}
out = []
for mname, spec in {cases}:
    shape, names = meshes[mname]
    m = jax.make_mesh(tuple(shape), tuple(names),
                      axis_types=(AxisType.Auto,) * len(names))
    pos = {{d: c for c, d in np.ndenumerate(m.devices)}}
    spec = tuple(tuple(a) if isinstance(a, list) else a for a in spec)
    blocks = {{}}
    for d, idx in NamedSharding(m, P(*spec)).devices_indices_map(
            {shape}).items():
        blocks[",".join(map(str, pos[d]))] = [
            [s.start or 0, {shape}[i] if s.stop is None else s.stop]
            for i, s in enumerate(idx)]
    out.append(blocks)
print(json.dumps(out))
"""


class TestPlacements:
    @pytest.fixture(scope="class")
    def reference_blocks(self):
        code = _REFERENCE_MAPS.format(meshes=PLACE_MESHES,
                                      cases=PLACE_CASES + REFUSED_CASES,
                                      shape=PLACE_SHAPE)
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   JAX_PLATFORMS="cpu")
        res = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                             capture_output=True, text=True, timeout=300,
                             env=env, cwd=ROOT)
        assert res.returncode == 0, res.stderr[-3000:]
        return json.loads(res.stdout.strip().splitlines()[-1])

    @pytest.fixture(scope="class")
    def port_blocks(self):
        """Each case's block of each rank (by mesh coordinate), from
        DTensor's own local shape and offset, under a fake group of 8 in
        which this process is that rank; the cases of ``PLACE_CASES``
        then those of ``REFUSED_CASES``."""
        cases = PLACE_CASES + REFUSED_CASES
        out = [dict() for _ in cases]
        for rank in range(8):
            dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                    world_size=8)
            try:
                ms = {k: mesh.mesh_over(s, n, "cpu")
                      for k, (s, n) in PLACE_MESHES.items()}
                for i, (mname, spec) in enumerate(cases):
                    m = ms[mname]
                    size, off = compute_local_shape_and_global_offset(
                        PLACE_SHAPE, m, shd.placements(m, spec))
                    key = ",".join(map(str, m.get_coordinate()))
                    out[i][key] = [[o, o + s] for o, s in zip(off, size)]
            finally:
                dist.destroy_process_group()
        return out

    @pytest.mark.parametrize("i", range(len(PLACE_CASES)),
                             ids=[f"{m}-{s}" for m, s in PLACE_CASES])
    def test_blocks_match_devices_indices_map(self, reference_blocks,
                                              port_blocks, i):
        assert port_blocks[i] == reference_blocks[i]

    def test_reversed_major_order_refused(self, reference_blocks,
                                          port_blocks):
        """The specs sharded against mesh order, once refused and now
        placed by ``_StridedShard``, give every rank the reference's
        block; a spec no placement expresses exactly still raises, naming
        it (here: a strided split that is checked and found wrong)."""
        n = len(PLACE_CASES)
        for i, case in enumerate(REFUSED_CASES):
            assert port_blocks[n + i] == reference_blocks[n + i], case
        assert shd._gives_reference_blocks(
            ("data", "model"), (2, 4), (("model", "data"), None),
            (Shard(0), Shard(0))) is False

    def test_strided_distribute_gathered_replace_mesh(self):
        """``distribute``, ``gathered`` and ``elastic.replace_mesh`` on a
        reversed-major spec, every rank simulated in one process
        (``LocalTensorMode``): each rank's block is the reference's, and
        gathering gives the whole tensor back on every rank."""
        from torch.distributed._local_tensor import LocalTensorMode
        from repro_torch.training import elastic
        x = torch.arange(8 * 12 * 3, dtype=torch.float32).reshape(8, 12, 3)
        spec = (("model", "data"), None, None)
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=8)
        try:
            with LocalTensorMode(8):
                m = mesh.mesh_over((2, 4), ("data", "model"), "cpu")
                for placed in (shd.distribute(x, m, spec),
                               elastic.replace_mesh({"w": x}, {"w": spec},
                                                    m)["w"]):
                    assert any(isinstance(p, _StridedShard)
                               for p in placed.placements)
                    local = placed.to_local()._local_tensors
                    for r, t in local.items():
                        i_data, i_model = divmod(r, 4)
                        blk = i_model * 2 + i_data
                        assert torch.equal(t, x[blk:blk + 1]), r
                    whole = shd.gathered(placed)._local_tensors
                    assert all(torch.equal(t, x) for t in whole.values())
        finally:
            dist.destroy_process_group()
