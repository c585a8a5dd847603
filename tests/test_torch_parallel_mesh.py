"""The port's data-parallel plumbing that needs no second process
(tpu_unet_torch/parallel/, data/loader.py): the FSDP leaf policy against the
JAX package's on every leaf of the full-size ladders, make_mesh's and
maybe_initialize's refusals against the JAX package's, the loader's
per-rank batches against the JAX loader's per-process ones, the
single-process passthroughs, and the K1/K2 wrappers entering their
tensor's device before a launch."""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_unet.models as jmodels
import tpu_unet_torch.ops.kernels.build as kbuild
import tpu_unet_torch.ops.kernels.int8_conv as k2
import tpu_unet_torch.ops.kernels.preprocess as k1
from tpu_unet.data.loader import DataLoader as JaxDataLoader
from tpu_unet.parallel import make_mesh as jax_make_mesh
from tpu_unet.parallel.fsdp import leaf_partition_spec as jax_leaf_spec
from tpu_unet.parallel.mesh import maybe_initialize as jax_maybe_initialize
from tpu_unet_torch.data.loader import DataLoader
from tpu_unet_torch.models import build_model
from tpu_unet_torch.parallel import (all_gather_host_values, broadcast_from_host0,
                                     local_rows, psum_scalar)
from tpu_unet_torch.parallel.collectives import gather_batches, gather_objects
from tpu_unet_torch.parallel.fsdp import fsdp_dims, leaf_partition_spec
from tpu_unet_torch.parallel.mesh import (batch_rows, broadcast_tensors, local_rank_devices,
                                          make_mesh, maybe_initialize, shard_batch,
                                          synced_timestamp)
from tpu_unet_torch.utils.weights import jax_trees_from_state_dict

_LADDERS = {"anomaly_unet": ({}, lambda: jmodels.AnomalyUNet(base_features=64)),
            "seg_unet": ({"n_classes": 3},
                         lambda: jmodels.build_model("seg_unet", n_classes=3, base_features=64))}


@functools.lru_cache(maxsize=None)
def _ladder(name):
    """The port's full-size model and the JAX model's parameter shapes."""
    kw, jax_model = _LADDERS[name]
    model = build_model(name, base_features=64, **kw)
    key = jax.random.key(0)
    shapes = jax.eval_shape(
        lambda: jax_model().init({"params": key, "dropout": key},
                                 jnp.zeros((1, 64, 64, 3)), train=False))["params"]
    return model, shapes


def _leaves(tree, path=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{path}/{k}")
        else:
            yield f"{path}/{k}", tree[k]


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("name", sorted(_LADDERS))
def test_leaf_policy_matches_jax_on_every_full_size_leaf(name, n):
    """Each parameter's shard dim, mapped to the JAX layout, is the dim the
    JAX policy picks (or both replicate): a tensor that varies along the
    port's chosen dim only, carried into the JAX layout by the weight map,
    varies along the JAX spec's dim."""
    model, shapes = _ladder(name)
    dims = fsdp_dims(model, n)
    marked = {}
    for pname, p in model.named_parameters():
        d = dims[pname]
        if d is None:
            marked[pname] = torch.zeros(p.shape).expand(p.shape)
        else:
            view = [1] * p.dim()
            view[d] = -1
            marked[pname] = torch.arange(p.shape[d], dtype=torch.float32).view(view).expand(
                p.shape)
    params, _ = jax_trees_from_state_dict(marked, model=name)
    jleaves = dict(_leaves(shapes))
    count = sharded = 0
    for path, arr in _leaves(params):
        spec = tuple(jax_leaf_spec(jleaves[path].shape, n))
        assert arr.shape == jleaves[path].shape, path
        assert leaf_partition_spec(arr.shape, n) == spec, path
        varies = [a for a in range(arr.ndim) if np.ptp(arr, axis=a).max() > 0]
        want = [spec.index("data")] if spec else []
        assert varies == want, (path, varies, spec)
        count, sharded = count + 1, sharded + bool(spec)
    assert count == len(jleaves) == len(dims) and sharded > 0.3 * count


def test_make_mesh_refuses_what_jax_refuses(devices):
    """The counterparts of the JAX package's mesh tests (ValueError); a
    'space' or a 'model' axis needs a process group
    (tests/test_torch_parallel_spatial.py and tests/test_torch_parallel_tensor.py
    build one)."""
    eight = list(range(8))
    for kw in ({"n_data": 16}, {"n_data": 4, "n_space": 2, "n_model": 2},
               {"n_model": 16}):
        with pytest.raises(ValueError):
            jax_make_mesh(**kw)
        with pytest.raises(ValueError, match="devices"):
            make_mesh(devices=eight, **kw)
    for kw in ({"n_model": 0}, {"n_space": 0}, {"n_data": 0}, {"n_model": -1}):
        with pytest.raises(ValueError, match=">= 1"):
            jax_make_mesh(**kw)
        with pytest.raises(ValueError, match=">= 1"):
            make_mesh(devices=eight, **kw)
    jax_make_mesh(n_data=4, n_space=2)
    with pytest.raises(ValueError, match="4x2x1 \\(data x space x model\\) mesh needs a "
                                         "process group"):
        make_mesh(devices=eight, n_data=4, n_space=2)
    jax_make_mesh(n_data=2, n_model=2)
    with pytest.raises(ValueError, match="process group"):
        make_mesh(devices=eight, n_data=2, n_model=2)
    # One process without a group: the plain path, or a refusal.
    assert make_mesh(1) is None
    with pytest.raises(ValueError, match="process group"):
        make_mesh(2, devices=eight)


def test_maybe_initialize_refuses_a_half_specified_launch(monkeypatch):
    for kw in ({"coordinator_address": "host:7777"}, {"process_id": 1}):
        with pytest.raises(ValueError, match="num_processes"):
            jax_maybe_initialize(**kw)
        with pytest.raises(ValueError, match="num_processes"):
            maybe_initialize(**kw)
    with pytest.raises(ValueError, match="coordinator_address"):
        maybe_initialize(num_processes=2, device_type="cpu")
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "SLURM_PROCID",
                "SLURM_NTASKS"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        maybe_initialize(auto=True, device_type="cpu")
    assert maybe_initialize() is False  # no flags: one process


def test_local_launch_devices():
    """CPU ranks share the CPU; GPUs are one per rank, and more ranks than
    GPUs raise (none here)."""
    assert local_rank_devices(None, "cpu") == [torch.device("cpu")]
    assert local_rank_devices(3, "cpu") == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="needs 2 GPUs"):
        local_rank_devices(2, "cuda")
    with pytest.raises(ValueError, match=">= 1"):
        local_rank_devices(0, "cpu")


class _Indexed:
    """A dataset whose sample i is filled with i."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def load(self, i):
        return {"image": np.full((2, 2, 3), i, np.uint8), "label": np.int64(i % 2),
                "image_path": f"img_{i}.png"}


@pytest.mark.parametrize("mode", ["pad_last", "drop_last"])
def test_loader_rank_blocks_equal_the_jax_loaders(mode):
    """Each rank's batches equal the JAX loader's process_count=2 blocks:
    rows, the padded rows' valid mask and the string fields, epoch by epoch
    of a shuffled order."""
    ds = _Indexed(13)
    kw = dict(batch_size=4, shuffle=True, seed=3, num_workers=2, **{mode: True})
    for r in range(2):
        port = DataLoader(ds, process_count=2, process_index=r, **kw)
        ref = JaxDataLoader(ds, process_count=2, process_index=r, **kw)
        for _ in range(2):  # two epochs, two orders
            got, want = list(port), list(ref)
            assert len(got) == len(want) == len(port)
            for a, b in zip(got, want):
                assert set(a) == set(b)
                np.testing.assert_array_equal(a["image"], b["image"])
                np.testing.assert_array_equal(a["label"], b["label"])
                assert a["image_path"] == b["image_path"]
                if mode == "pad_last":
                    np.testing.assert_array_equal(a["valid"], b["valid"])


def test_loader_gives_each_rank_its_block_of_every_microbatch():
    """Under grad_accum the rows of rank r are, microbatch by microbatch, the
    rows the JAX step's microbatch i (global rows [i N/G, (i+1) N/G)) puts
    on it; chunking them in G gives the rank's part of each microbatch."""
    ds = _Indexed(16)
    whole = list(JaxDataLoader(ds, 8, shuffle=True, seed=1, drop_last=True,
                               process_count=1, process_index=0))
    parts = [list(DataLoader(ds, 8, shuffle=True, seed=1, drop_last=True, process_count=2,
                             process_index=r, grad_accum=2)) for r in range(2)]
    for b, batch in enumerate(whole):
        ids = batch["image"][:, 0, 0, 0]
        for i in range(2):  # microbatch i of the global batch
            micro = ids[i * 4:(i + 1) * 4]
            got = np.concatenate([parts[r][b]["image"][i * 2:(i + 1) * 2, 0, 0, 0]
                                  for r in range(2)])
            np.testing.assert_array_equal(got, micro)
    np.testing.assert_array_equal(batch_rows(8, 2, 2, 1), [2, 3, 6, 7])
    np.testing.assert_array_equal(batch_rows(8, 1, 2, 1), [4, 5, 6, 7])
    with pytest.raises(ValueError, match="divisible"):
        DataLoader(ds, 6, process_count=2, process_index=0, grad_accum=2)
    with pytest.raises(ValueError, match="drop_last or pad_last"):
        list(DataLoader(ds, 6, process_count=2, process_index=0))


def test_one_process_is_a_passthrough():
    """Without a process group every helper is the identity (or the local
    value) and the loader gives whole batches."""
    x = np.arange(6.0).reshape(3, 2)
    np.testing.assert_array_equal(all_gather_host_values(x), x)
    np.testing.assert_array_equal(gather_batches(x, 3), x)
    assert gather_objects(["a", "b"], 2) == ["a", "b"]
    assert psum_scalar(np.ones(5)) == 5.0
    np.testing.assert_array_equal(local_rows(torch.ones(2)), np.ones(2))
    assert broadcast_from_host0({"t": 1}) == {"t": 1}
    batch = {"image": np.arange(4), "path": list("abcd")}
    assert shard_batch(batch)["path"] == list("abcd")
    tree = {"scales": [torch.ones(2)]}
    assert broadcast_tensors(tree) is tree
    ts = synced_timestamp()
    assert len(ts) == 15 and ts[8] == "_"
    assert len(next(iter(DataLoader(_Indexed(4), 4)))["image"]) == 4


@contextlib.contextmanager
def _fake_launch(monkeypatch):
    """Record the device each K1/K2 launch makes current, with a stand-in
    library whose entry points return success."""
    entered = []

    class _Lib:
        def __getattr__(self, name):
            return lambda *args: 0

    @contextlib.contextmanager
    def device(d):
        entered.append(torch.device(d))
        yield

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(kbuild, "load", lambda name: _Lib())
    monkeypatch.setattr(kbuild, "current_stream", lambda d: 0)
    monkeypatch.setattr(k1.normalize_u8, "launches", 0)
    monkeypatch.setattr(k2.conv3x3_int8, "launches", 0)
    yield entered


def test_kernel_wrappers_enter_the_tensors_device(monkeypatch):
    """K2 sets its shared-memory attribute on the current device and both
    kernels launch on the current device's stream: each wrapper makes the
    tensor's device current around the launch (a serving replica on a
    second GPU is called while the first is current)."""
    with _fake_launch(monkeypatch) as entered:
        x = torch.zeros((1, 4, 4, 32), dtype=torch.int8)
        w = torch.zeros((16, 3, 3, 32), dtype=torch.int8)
        k2._launch(x, w, torch.ones(16), torch.zeros(16), torch.ones(1), True)
        k1._launch(torch.zeros((1, 4, 4, 3), dtype=torch.uint8), [0.5] * 3, [0.2] * 3,
                   torch.float32)
    assert entered == [x.device, x.device]
    assert k2.conv3x3_int8.launches == 1 and k1.normalize_u8.launches == 1
