"""The 'space' axis's primitives, mesh and predictor (gloo CPU ranks).

- ``parallel/spatial.py`` on 2 and 4 space ranks: a 3x3 conv through
  ``halo_rows`` against the whole image's conv (float64: forward, input
  and weight gradients, 1e-12), the sharded align-corners resizes (the 2x
  upsample and the gate's resize of psi) against ``ops/resize.py`` on the
  whole image (bfloat16 bit for bit; float32 within 2 ulp: the rank's
  matmul contracts over its rows plus two halo rows, the whole image's
  over all rows, and the BLAS adds the two taps in an order that depends
  on that length), ``split_rows``/``gather_rows``, ``check_rows`` (the
  JAX package's refusal only: ``n_space`` must divide the height).
- The row plan of uneven levels (the max-pool's floor, one-row and empty
  blocks) and every row operation on it (``move_rows`` under the pool,
  the level-up's pad, the gate's stride 2 and resize, the bilinear
  upsample, the halo'd 3x3 conv), forward and input gradient against the
  op on the whole tensor sliced to the rank's rows, for every height
  ``H <= 96`` that 2, 3 or 4 ranks divide (float64; exact for the moves,
  1e-12 for the conv and the resizes).
- The 3-D mesh's shape, ranks and coordinates against the JAX package's
  ``make_mesh(n_data=2, n_space=2, n_model=2)``.
- ``SegmentationPredictor`` with ``n_devices=2, n_space=2`` in one process
  (``tests/test_serve.py``'s modes): f32 masks equal to one device's and
  confidences within rtol 2e-5, int8 bit for bit; the same at heights
  whose deeper levels split unevenly (40 rows on 2 devices, 32 on 4: a
  bottleneck rank with no rows); the JAX predictor's refusals (tiling with
  ``n_space``, a height ``n_space`` does not divide).
- Marked slow, as its JAX counterpart ``tests/test_spatial_kolektorsdd.py``:
  the seg step at 1024 x 512 on 8 space ranks against world size 1.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import _torch_space_workers as workers
from _torch_parity import one_torch_thread, seeded_state_dict, seg_batch  # noqa: F401
from tpu_unet.parallel import make_mesh as jax_make_mesh
from tpu_unet_torch.models import build_model
from tpu_unet_torch.ops.augment import sample_augment_draws
from tpu_unet_torch.ops.resize import resize_bilinear_align_corners
from tpu_unet_torch.parallel.mesh import launch
from tpu_unet_torch.parallel.spatial import check_rows, row_plan
from tpu_unet_torch.serve import SegmentationPredictor
from tpu_unet_torch.train.steps import AugmentConfig, SegLossConfig


@pytest.mark.parametrize("n_space", [2, 4])
def test_halo_conv_and_row_resizes_match_the_whole_image(n_space):
    out = launch(workers.primitives, (n_space,), devices=["cpu"] * n_space, timeout=60)
    x, w, gy = (out[k].requires_grad_() if k != "gy" else out[k] for k in ("x", "w", "gy"))
    y = F.conv2d(x, w, padding=1)
    (y * gy).sum().backward()
    np.testing.assert_allclose(out["conv"].numpy(), y.detach().numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(out["dx"].numpy(), x.grad.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(out["dw"].numpy(), w.grad.numpy(), rtol=0, atol=1e-12)
    for dt in (torch.float32, torch.bfloat16):
        a, got = out[f"up_{dt}"]
        g, got_gate = out[f"gate_{dt}"]
        want = resize_bilinear_align_corners(a, a.shape[2] * 2, 12)
        want_gate = resize_bilinear_align_corners(g, g.shape[2] * 2, 6)
        if dt == torch.bfloat16:
            assert torch.equal(got, want) and torch.equal(got_gate, want_gate)
        else:
            for t, ref in ((got, want), (got_gate, want_gate)):
                np.testing.assert_allclose(t.numpy(), ref.numpy(), rtol=2.4e-7, atol=1e-7)
    assert out["round_trip"]
    # The conv's halo in the forward and in the backward, then one halo for
    # each of the 4 resizes.
    assert out["counters"]["exchanges"] == 2 + 4


def test_check_rows_refuses_uneven_levels():
    """The JAX package's refusal alone: level 0's blocks must be equal."""
    check_rows(1024, 8)  # KolektorSDD at 8 ranks: 8-row bottleneck blocks
    check_rows(512, 4)
    check_rows(48, 1)  # no 'space' axis: anything goes
    check_rows(96, 4)  # 24-row blocks: the third level's 3 rows pool unevenly
    check_rows(1240, 2)
    with pytest.raises(ValueError, match="must divide the image height 100"):
        check_rows(100, 8)


def test_row_plan_follows_the_max_pool_floor():
    """Each rank keeps the pooled rows whose pair starts in its block: an
    odd level splits unevenly, the floor drops an odd last row, a rank may
    hold one row or none."""
    assert row_plan(40, 2).levels == [((0, 20), (20, 40)), ((0, 10), (10, 20)),
                                      ((0, 5), (5, 10)), ((0, 3), (3, 5)), ((0, 2), (2, 2))]
    sizes = lambda h, n: [[b - a for a, b in lv] for lv in row_plan(h, n).levels]  # noqa: E731
    assert sizes(48, 4)[3:] == [[2, 1, 2, 1], [1, 1, 1, 0]]
    assert sizes(96, 4) == [[24] * 4, [12] * 4, [6] * 4, [3] * 4, [2, 1, 2, 1]]
    assert sizes(1240, 2) == [[620, 620], [310, 310], [155, 155], [78, 77], [39, 38]]
    assert row_plan(1240, 2).totals == [1240, 620, 310, 155, 77]


@pytest.mark.parametrize("n_space", [2, 3, 4])
def test_row_moves_match_the_whole_image_at_every_height(n_space):
    heights = list(range(n_space, 97, n_space))
    out = launch(workers.moves, (n_space, heights), devices=["cpu"] * n_space, timeout=60)
    assert out["failures"] == []
    assert out["checked"] > 20 * len(heights)


def test_the_3d_mesh_follows_jax_rank_order(devices):
    jmesh = jax_make_mesh(n_data=2, n_space=2, n_model=2)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    coords = launch(workers.mesh_coords, (2, 2), devices=["cpu"] * 8, timeout=60)
    for c in coords:
        r = c["rank"]
        assert ids[c["data"], c["space"], c["model"]] == r
        assert c["names"] == tuple(jmesh.axis_names) and c["shape"] == jmesh.devices.shape
        assert c["sizes"] == (2, 2) and c["space_index"] == c["space"]
        assert c["mesh_data"] == (2, c["data"])  # the loaders' coordinates
        # The batch group: the data x space ranks of the rank's model index.
        assert c["batch"] == sorted(ids[:, :, c["model"]].ravel().tolist())
        assert c["space_group"] == ids[c["data"], :, c["model"]].tolist()


KW = dict(num_classes=4, image_size_hw=(32, 32), batch_size=4, base_features=4, device="cpu")


@pytest.fixture(scope="module")
def predictor_inputs():
    rng = np.random.default_rng(0)
    return (seeded_state_dict("seg_unet", 43, n_classes=4, base_features=4),
            rng.integers(0, 256, (6, 32, 32, 3), dtype=np.uint8),
            rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8))


@pytest.mark.parametrize("mode", ["f32", "int8"])
def test_data_space_predictor_matches_one_device(predictor_inputs, mode):
    sd, images, calib = predictor_inputs
    kw = dict(KW, precision="f32") if mode == "f32" else \
        dict(KW, quantize="int8", calib_images=calib)
    one = SegmentationPredictor.from_state_dict(sd, **kw)
    mesh = SegmentationPredictor.from_state_dict(sd, n_devices=2, n_space=2, **kw)
    assert mesh.devices == [torch.device("cpu")] * 4 and mesh.n_space == 2
    m1, c1 = one.predict_array(images)
    m2, c2 = mesh.predict_array(images)
    np.testing.assert_array_equal(m2, m1)
    if mode == "int8":
        np.testing.assert_array_equal(c2, c1)
    else:
        np.testing.assert_allclose(c2, c1, rtol=2e-5)


def test_space_predictor_refusals(predictor_inputs):
    sd = predictor_inputs[0]
    with pytest.raises(ValueError, match="tiled inference does not compose"):
        SegmentationPredictor.from_state_dict(sd, n_space=2, tile_hw=(32, 32),
                                              **dict(KW, image_size_hw=(64, 64)))
    with pytest.raises(ValueError, match="n_space 4 must divide the image height 30"):
        SegmentationPredictor.from_state_dict(sd, n_space=4, **dict(KW, image_size_hw=(30, 32)))


@pytest.mark.parametrize("height,n_space,mode", [(40, 2, "f32"), (40, 2, "int8"),
                                                 (32, 4, "int8")])
def test_space_predictor_at_uneven_levels_matches_one_device(predictor_inputs, height, n_space,
                                                             mode):
    """Heights the port once refused: 40 rows on 2 devices (levels of 5, 3
    and 2 rows, a bottleneck device with none), 32 on 4 (one-row blocks,
    two bottleneck devices with none). int8 bit for bit one device's, f32
    masks equal and confidences within rtol 2e-5."""
    sd, _, calib = predictor_inputs
    images = np.random.default_rng(height).integers(0, 256, (4, height, 32, 3), np.uint8)
    kw = dict(KW, image_size_hw=(height, 32))
    kw.update(precision="f32") if mode == "f32" else \
        kw.update(quantize="int8", calib_images=calib[:, :32])
    one = SegmentationPredictor.from_state_dict(sd, **kw)
    rows = SegmentationPredictor.from_state_dict(sd, n_space=n_space, **kw)
    m1, c1 = one.predict_array(images)
    m2, c2 = rows.predict_array(images)
    np.testing.assert_array_equal(m2, m1)
    if mode == "int8":
        np.testing.assert_array_equal(c2, c1)
    else:
        np.testing.assert_allclose(c2, c1, rtol=2e-5)


@pytest.mark.slow
def test_h_sharded_seg_step_matches_unsharded_at_1024x512():
    """8 space ranks (8-row bottleneck blocks), KolektorSDD's class weights,
    no rotation: the tolerances of the JAX package's test, but for the
    confusion matrix, held to 1e-4 of the pixels: at this random init the
    class logits nearly tie, and the CPU conv's rounding, which differs
    between 1024-row and 130-row inputs, moved 40 of 1,048,576 argmaxes in
    one run (the losses and parameters stay within the JAX tolerances)."""
    torch.manual_seed(0)
    kw = {"n_classes": 3, "base_features": 4, "dropout": 0.0}
    sd = build_model("seg_unet", **kw).state_dict()
    images, _ = seg_batch(0, n=2, h=1024, w=512)
    labels = np.zeros((2, 1024, 512), np.uint8)
    labels[:, 400:430, 100:140] = 1
    labels[:, 700:720, 300:360] = 2
    aug = AugmentConfig(degrees=0.0)
    draws = sample_augment_draws(2, aug, torch.Generator().manual_seed(7))
    loss = SegLossConfig(class_weights=(1.0, 50.0, 50.0))
    args = ("seg_unet", sd, kw)
    cases = [(draws, None, 1, False, None)]
    one = workers.seg_cases(*args, 1, 1, cases, images, labels, loss, aug, 1e-2, 0.0)[0]
    rows = launch(workers.seg_cases, (*args, 8, 1, cases, images, labels, loss, aug, 1e-2, 0.0),
                  devices=["cpu"] * 8, timeout=600)[0]
    for k, v in one["losses"].items():
        assert abs(rows["losses"][k] - v) < 1e-4 * max(1.0, abs(v)), k
    assert rows["cm"].sum() == one["cm"].sum()
    assert np.abs(rows["cm"] - one["cm"]).sum() <= 1e-4 * one["cm"].sum()
    for k, v in one["state"].items():
        np.testing.assert_allclose(rows["state"][k], v, rtol=2e-4, atol=2e-5, err_msg=k)
