"""The port's mesh (viquae_torch/core/mesh.py) and parallelism surface
(viquae_torch/parallel.py): the cases of tests/test_core.py:11-25 (axes and
sizes), held to the JAX mesh on its 8-device virtual CPU mesh, then a gloo
world of 4 processes (tests/torch_dist_helpers.py): the grid order, each
axis' gather in coordinate order, the row split and gather, and a world
whose rank hangs failing within its time limit."""
import time

import jax
import numpy as np
import pytest
import torch

import torch_dist_helpers as tdh
from viquae_torch import parallel
from viquae_torch.core import mesh
from viquae_tpu.core import mesh as jmesh

torch.set_num_threads(2)


def test_axis_names_and_grid_order_are_the_references():
    assert (mesh.DATA_AXIS, mesh.MODEL_AXIS, mesh.KB_AXIS,
            mesh.PIPE_AXIS) == (jmesh.DATA_AXIS, jmesh.MODEL_AXIS,
                                jmesh.KB_AXIS, jmesh.PIPE_AXIS)
    ref = jmesh.make_mesh(data=2, model=2, kb=2)
    assert mesh.AXES == tuple(ref.mesh.axis_names)
    for name in ("MeshContext", "current", "make_kb_mesh", "make_mesh",
                 "use", "topk_sharded", "DATA_AXIS", "KB_AXIS"):
        assert hasattr(parallel, name), name


def test_world_of_one_without_a_process_group(devices):
    """test_core.py:11-25 without processes: the default mesh is a world
    of one on the caller's device, sizes 1, no collective; a mesh larger
    than the world raises, as the reference's assert does."""
    ctx = mesh.make_mesh()
    assert (ctx.data_size, ctx.model_size, ctx.kb_size, ctx.pipe_size) == (
        1, 1, 1, 1)
    assert not ctx.distributed and ctx.rank == 0 and ctx.group("kb") is None
    assert mesh.make_kb_mesh().kb_size == 1
    assert mesh.current().device is None
    with pytest.raises(ValueError, match="2x1x1x1 != 1"):
        mesh.make_mesh(data=2)
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(mesh.all_gather(ctx, x, mesh.KB_AXIS), x[None])
    assert torch.equal(mesh.gather_rows(ctx, mesh.split_rows(ctx, x), 3), x)
    assert list(ctx.collective_log) == []
    assert mesh.collective_route(ctx) == "local"
    assert mesh.pad_to_multiple(10, 8) == jmesh.pad_to_multiple(10, 8) == 16


def test_collective_log_keeps_only_the_last_entries(tmp_path):
    """A server's collectives never grow the log past
    COLLECTIVE_LOG_LEN entries (a gloo world of one in this process)."""
    import datetime

    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        ctx = mesh.make_kb_mesh(device="cpu")
        for n in range(1, mesh.COLLECTIVE_LOG_LEN + 11):
            mesh.all_gather(ctx, torch.zeros(n), mesh.KB_AXIS)
    finally:
        dist.destroy_process_group()
    log = list(ctx.collective_log)
    assert len(log) == mesh.COLLECTIVE_LOG_LEN
    assert log[0] == ("all_gather", "kb", 11 * 4)
    assert log[-1] == ("all_gather", "kb", (mesh.COLLECTIVE_LOG_LEN + 10) * 4)


def test_use_nests_and_restores():
    outer = mesh.make_mesh(device="cpu")
    inner = mesh.make_mesh(device="cpu")
    with mesh.use(outer):
        assert mesh.current() is outer
        with mesh.use(inner):
            assert mesh.current() is inner
        assert mesh.current() is outer
    assert mesh.current() is not outer and mesh.current().device is None


def test_init_from_env_reads_torchruns_variables(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert mesh.init_from_env("cpu") == torch.device("cpu")
    (args, kw), = calls
    assert args == ("gloo",) and kw["rank"] == 3 and kw["world_size"] == 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        mesh.init_from_env()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return tdh.run_world("mesh", 4, tmp_path_factory.mktemp("mesh"))


def _rank_at(sizes, coords):
    """The rank at a grid coordinate, (data, pipe, model, kb) row-major —
    the reference's device order (mesh.py:112-113)."""
    r = 0
    for axis in mesh.AXES:
        r = r * sizes[axis] + coords[axis]
    return r


@pytest.mark.parametrize("name,sizes", [
    ("all_data", (4, 1, 1, 1)), ("data2_model2", (2, 1, 2, 1)),
    ("kb", (1, 1, 1, 4)), ("data2_kb2", (2, 1, 1, 2)),
    ("pipe2_kb2", (1, 2, 1, 2))])
def test_gloo_mesh_sizes_coordinates_and_axis_gathers(world, name, sizes):
    """Each rank's coordinates follow the reference's grid order; a gather
    along an axis returns that axis' ranks in coordinate order (the other
    coordinates fixed); the sizes are test_core.py's."""
    ref = jmesh.make_mesh(*[dict(zip(mesh.AXES, sizes))[a] for a in (
        "data", "model", "kb", "pipe")], devices=jax.devices()[:4])
    for rank, res in enumerate(world):
        got = res["meshes"][name]
        assert tuple(got["sizes"][a] for a in mesh.AXES) == sizes
        assert (ref.data_size, ref.pipe_size, ref.model_size,
                ref.kb_size) == sizes
        assert _rank_at(got["sizes"], got["coords"]) == rank
        assert got["route"] == "gloo"
        for axis in mesh.AXES:
            expect = [_rank_at(got["sizes"], {**got["coords"], axis: c})
                      for c in range(got["sizes"][axis])]
            assert got["gathered"][axis] == expect, (rank, axis)


def test_gloo_mesh_refuses_a_shape_that_is_not_the_world(world):
    assert all(res["bad_mesh"] == "mesh 3x1x1x1 != 4 processes"
               for res in world)


def test_gloo_split_rows_and_gather_rows_round_trip(world):
    """11 rows over data = 2: blocks of 6, the last padded with a zero row;
    the gather gives the 11 rows back on every rank, one data gather of
    2 x 6 x 3 x 4 bytes logged."""
    x = np.arange(11 * 3, dtype=np.float32).reshape(11, 3)
    for res in world:
        part, back, log = res["split"]
        assert part.shape == (6, 3)
        np.testing.assert_array_equal(back, x)
        assert log == [("all_gather", "data", 2 * 6 * 3 * 4)]
    data_coord = [res["meshes"]["data2_kb2"]["coords"]["data"]
                  for res in world]
    for res, c in zip(world, data_coord):
        expect = np.concatenate([x, np.zeros((1, 3), np.float32)])[
            6 * c: 6 * c + 6]
        np.testing.assert_array_equal(res["split"][0], expect)


def test_a_hung_rank_fails_the_world_within_its_time_limit(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(tdh.WorldTimeout, match="ranks still running"):
        tdh.run_world("hang", 2, tmp_path, timeout=8.0)
    assert time.monotonic() - t0 < 20.0
