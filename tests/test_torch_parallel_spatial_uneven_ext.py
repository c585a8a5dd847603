"""The model extensions on the 'space' axis at a height whose deeper
levels split unevenly: 40 rows on a (1, 2) mesh (levels of 20/20, 10/10,
5/5, 3/2 and 2/0 rows; gloo CPU ranks, the tolerances of
``tests/test_torch_parallel_spatial_seg.py``), against the JAX seg step
on the same mesh, one SGD step:

- the attention UNet: the gate's stride 2 on the image's even rows, its
  BatchNorm over the odd level's ceil rows, the resize of psi reaching two
  rows past a rank's block;
- UNet++ with deep supervision: every node's pool and level-up;
- the bilinear SegmentationUNet: the align-corners upsample into the
  skip's rows, the pad's zero row on the rank that holds the level's last
  row.
"""

import jax
import pytest

import _torch_space_workers as workers
from _torch_parity import one_torch_thread, seg_batch  # noqa: F401
from test_torch_parallel_spatial_seg import (AUG, BASE, C, LOSS, LR, N, W, WD,
                                             assert_matches_jax, jax_case, seeded)
from tpu_unet.parallel import make_mesh as jax_make_mesh
from tpu_unet_torch.parallel.mesh import launch

H = 40
CASES = {
    "attn_unet": ("attn_unet", {}),
    "unetpp_deep_supervision": ("unetpp", {"deep_supervision": True}),
    "seg_unet_bilinear": ("seg_unet", {"bilinear": True}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_space_step_at_uneven_levels_matches_jax(devices, case):
    name, extra = CASES[case]
    sd = seeded(name, **extra)
    model_kw = {"n_classes": C, "base_features": BASE, **extra}
    images, labels = seg_batch(11, n=N, h=H, w=W, num_classes=C)
    ref, draws, keep = jax_case(name, sd, model_kw, jax_make_mesh(n_data=1, n_space=2),
                                images, labels, jax.random.key(3))
    port = launch(workers.seg_cases, (name, sd, model_kw, 2, 1,
                                      [(draws, keep, 1, False, None)], images, labels, LOSS,
                                      AUG, LR, WD), devices=["cpu"] * 2, timeout=120)[0]
    assert_matches_jax(port, ref, name)
