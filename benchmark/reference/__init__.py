"""The benchmark's plain reference: PC2 (ViT-S/16 conditioning, the
projection, PVCNN2), PVD, the DDPM and Gaussian steps, the blend and AdamW
with clipping, in plain PyTorch at float32 (TF32 off).

It imports neither JAX nor the JAX package nor anything of the port. It is
written from the original PyTorch sources' semantics, channel-last, with
parameter names and shapes of the original checkpoints, so one state dict
loads into the reference and into the port alike.

Departures from the original sources, each harmless to what is compared:
  * channel-last layout throughout (the original is channel-first);
  * the timestep embedding is broadcast per point where the original
    groups, max-pools or interpolates it along the points (it is constant
    along them, so the result is the same up to the rounding of weights
    that sum to one);
  * the squeeze-excitation gate multiplies the devoxelized points instead
    of the grid (it is one scale a channel, and devoxelization is linear);
  * the CUDA geometry of the original (FPS, ball query, three-NN,
    voxelization, devoxelization, the rasterizer) is vectorised PyTorch of
    the same documented semantics, with each distance rounded operation by
    operation as (dx*dx + dy*dy) + dz*dz;
  * every product's operands pass through a `Precision`, float32 unless
    the control asks for a lower one (`precision.py`).
"""
