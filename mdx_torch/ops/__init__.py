"""Device ops on batched ``[N, H, W]`` float32 tensors (PyTorch).

Counterparts of ``mdx.ops``, one module each: ``filters``, ``hist``,
``quantile``, ``wavelet``, ``clahe``, ``tv``, ``bilateral``, ``ssim``.
Boundary conventions are the JAX package's: SciPy ``reflect``
(= ``jnp.pad(mode="symmetric")``, edge repeated) for the box and Sobel
stencils, skimage ``nearest`` (= edge) for the Gaussian, ``reflect``
without edge repeat for bilateral and the CLAHE tile pad.  Every stencil is
a shift-add on slices (no ``F.conv2d``): cuDNN's float32 convolutions may
run in TF32, and the shift-adds keep the JAX package's accumulation order.

The modules are not re-exported here: ``clahe``, ``bilateral`` and
``ssim`` name both a module and its function.
"""
