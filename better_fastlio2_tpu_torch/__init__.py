"""better_fastlio2_tpu_torch — the PyTorch/CUDA port of better_fastlio2_tpu.

Runs the per-scan LIO front end (IMU propagation and undistortion, FoV
crop, voxel downsample, 5-NN or moment-plane association with the
iterated ESIKF update, map insert) on one NVIDIA GPU.  The ESIKF normal
equations (ops/kernels.fused_normal_eqs and fused_hth) and the IMU stage
(ops/kernels.imu_stage) run as hand-written CUDA kernels; everything
else is plain PyTorch.  The JAX package beside this one is the reference: module
names and layout mirror it, and the tests hold each module against its JAX
counterpart.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``--device cpu`` for the command-line runners of run.py).
"""

import torch as _torch

# Full f32 everywhere.  The JAX reference pins its matmuls to "highest"
# because bf16 products made the filter diverge (a point-to-plane residual
# n·p at 60 m world coordinates picks up ~0.25 m of rounding).  On Hopper
# the same trap is TF32, which keeps ~3 decimal digits: keep it off.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
