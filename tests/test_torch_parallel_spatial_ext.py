"""The 'space' axis on the model extensions and with tensor parallelism,
against the JAX seg step on the same mesh (gloo CPU ranks; base 4, 32 x
16 px, 4 classes, a global batch of 4; the tolerances of
``tests/test_torch_parallel_spatial_seg.py``):

- the attention UNet on a (2, 2) ('data', 'space') mesh: its gates' resize
  of psi runs on the rank's rows of the global matrix. It is held at the
  tolerances above against the JAX step on one device, the unsharded
  reference. Against the JAX step on the (2, 2) mesh each parameter
  leaf's absolute tolerance is also at least twice JAX's own (2, 2)-against-
  one-device difference on that leaf: on this batch one pre-ReLU activation
  of ``up2``'s first DoubleConv conv (image 2, channel 2, row 5, column 0)
  lies within 4e-6 of zero, and the order of a run's reductions decides
  which side it falls on (5.9e-7 in the port's one-process step at one CPU
  thread, -3.7e-6 at four). Its gradient, 1.4e-4, then passes the ReLU
  or not, and every leaf below it moves by up to 1.2e-4. JAX's (2, 2) step
  and the port's one-process step at one thread fall on one side; JAX's
  one-device step and the port's ranks on the other;
- UNet++ with deep supervision and ``bilinear=True`` on (2, 2): every
  level-up is the sharded align-corners upsample;
- SegmentationUNet on a (1, 2, 2) ('data', 'space', 'model') mesh: each
  DoubleConv's halo exchange on each model rank's replicated input, its
  row all-reduce on the H-sharded output.
"""

import jax
import pytest

import _torch_space_workers as workers
from _torch_parity import one_torch_thread, seg_batch  # noqa: F401
from test_torch_parallel_spatial_seg import (BASE, C, H, LOSS, LR, N, W, WD, AUG,
                                             assert_matches_jax, jax_case, seeded)
from tpu_unet.parallel import make_mesh as jax_make_mesh
from tpu_unet_torch.parallel.mesh import launch

CASES = {
    "attn_unet": ({}, (2, 2, 1)),
    "unetpp": ({"deep_supervision": True, "bilinear": True}, (2, 2, 1)),
    "seg_unet": ({}, (1, 2, 2)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_space_step_matches_jax(devices, name):
    extra, (n_data, n_space, n_model) = CASES[name]
    sd = seeded(name, **extra)
    model_kw = {"n_classes": C, "base_features": BASE, **extra}
    images, labels = seg_batch(11, n=N, h=H, w=W, num_classes=C)
    mesh = jax_make_mesh(n_data=n_data, n_space=n_space, n_model=n_model)
    ref, draws, keep = jax_case(name, sd, model_kw, mesh, images, labels, jax.random.key(3),
                                tp=n_model > 1)
    spread = None
    if name == "attn_unet":
        spread = jax_case(name, sd, model_kw, jax_make_mesh(n_data=1, n_space=1), images,
                          labels, jax.random.key(3))[0]
    port = launch(workers.seg_cases, (name, sd, model_kw, n_space, n_model,
                                      [(draws, keep, 1, False, None)], images, labels, LOSS,
                                      AUG, LR, WD),
                  devices=["cpu"] * (n_data * n_space * n_model), timeout=120)[0]
    if keep is not None:
        assert not keep.all()  # the dropout drops channels
    assert_matches_jax(port, ref, name, spread)
    if spread is not None:  # the unsharded reference, at the tolerances alone
        assert_matches_jax(port, spread, name)
