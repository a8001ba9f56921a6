"""PyTorch + CUDA port of the Monte Carlo MRI nanoparticle simulator.

The JAX package (``mri_nanoparticle_simulation_tpu``) is the reference
this port is held against.  The port keeps its module names, imports
``torch`` and never ``jax``, and imports nothing of the JAX package: it
carries its own ``params`` (``Params``), ``scene`` (``BacteriaBox``,
``Scene`` and the native builder, whose C++ source is in its ``csrc/``),
``utils.cache`` (the coverage certificates), ``analysis`` (the T2 fits
and ``mri-t2-fit``), ``io.record`` (the decomposition record store) and
``golden`` (the reference's scene dumps).

Main path: ``engine.sim.SimulationRunner`` -> ``engine.cuda_engine``
sprints -> hand-written CUDA kernels bound in ``engine.chunk_kernel``:
one chunk kernel launch per chunk (``csrc/chunk_kernel.cu``), and on
large scenes the field model before it (``csrc/cand_model_kernel.cu`` or
``csrc/far_sums_kernel.cu``).  The phase-decomposition path
(``engine.decompose``, the CLI's ``--moment-scales``/``--echo-taucps``)
runs the same kernels in decompose mode (``csrc/*_dec.cu``), and folds
the (moment x taucp) plane on the device with ``--plane-device``.
"""
