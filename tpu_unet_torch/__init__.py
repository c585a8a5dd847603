"""tpu_unet_torch — the PyTorch / CUDA port of ``tpu_unet`` for NVIDIA Hopper.

A package of its own beside the JAX package: it imports ``torch`` and nothing
of JAX or of ``tpu_unet``. Module paths mirror ``tpu_unet``'s so each
counterpart is easy to find. Its TPU kernels are CUDA kernels written by hand
for ``sm_90a`` (``csrc/``), built at first use (``ops/kernels/build.py``).

It covers MVTec anomaly serving (``serve.AnomalyScorer``, ``cli.serve_mvtec``)
in f32, bf16 and int8, and training and testing (``train``, ``data``,
``cli.train_mvtec``, ``cli.test_mvtec``, ``cli.sweep_mvtec``), and the Gear
and KolektorSDD segmentation workloads (``cli.train_gear``,
``cli.test_gear``, ``cli.train_kolektorsdd``, ``cli.test_kolektorsdd``), data-parallel across
GPUs (``parallel``: one process per GPU, ``--n_devices``, FSDP2). Public
functions keep the JAX package's layout: NHWC
uint8 images in, ``(N,)`` float32 scores out. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``, and raise when ``cuda`` is asked
for and there is no GPU.
"""

__version__ = "0.1.0"
