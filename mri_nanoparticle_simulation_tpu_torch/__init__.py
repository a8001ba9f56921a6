"""PyTorch + CUDA port of the Monte Carlo MRI nanoparticle simulator.

The JAX package (``mri_nanoparticle_simulation_tpu``) is the reference
this port is held against.  The port keeps its module names, imports
``torch`` and never ``jax``, and reuses the reference's host-only modules
by import: ``params`` (``Params``), ``scene`` (``BacteriaBox``, ``Scene``
and the native builder) and ``utils.cache`` (the coverage certificates).

Main path: ``engine.sim.SimulationRunner`` -> ``engine.cuda_engine``
sprints -> hand-written CUDA kernels bound in ``engine.chunk_kernel``:
one chunk kernel launch per chunk (``csrc/chunk_kernel.cu``), and on
large scenes the field model before it (``csrc/cand_model_kernel.cu`` or
``csrc/far_sums_kernel.cu``).
"""
