"""PyTorch / CUDA port of ``freesurgs_tpu`` for one NVIDIA H100.

The JAX package beside this one is the reference: every module here keeps
its counterpart's path (``core/``, ``ops/``, ``models/``, ``train/``,
``data/``, ``eval/``, ``io/``, ``utils/``; ``cli/train.py`` and
``cli/render.py`` for the root ``train.py`` and ``render.py``) and
semantics, and the tests hold each against it on the same numpy inputs.
The tile-compositing kernels are hand-written CUDA under ``csrc/`` (see
``ops/raster_cuda.py``), beside the host I/O library ``csrc/fsio.cpp``
(``io/native.py``); everything else is plain PyTorch and numpy.

Entry points take ``device`` and default to ``"cuda"``; nothing moves to
the CPU by itself.
"""
