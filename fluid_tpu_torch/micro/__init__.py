"""The micro-benchmark entry points on the card: ports of ``bench/micro_sep.py``,
``micro_pb.py``, ``micro_dma.py`` and ``micro_zfac.py`` on the kernels
M1-M4 of ``ops/micro_kernels.py``, of ``bench/micro_kernels.py`` on the
kernels M5-M8 of ``ops/micro_stream.py``, and of
``bench/micro_zfac_probe.py`` (its construct probes ``p1``-``p13``) on the
kernels M9-M11 of ``ops/micro_probe.py``, one module each with the
script's file name.

Each ``make_*`` / ``case_*`` returns a callable on tensors (the JAX
script's returns a jitted callable), and each probe ``p1``-``p13`` is one,
with its plain PyTorch version as ``.plain``; each ``main(argv=None)`` runs on the card, holds every output
against its plain version, then times it with CUDA events and prints the
script's lines::

    python3 -m fluid_tpu_torch.micro.micro_zfac
    python3 -m fluid_tpu_torch.micro.micro_zfac_probe

Importing a module runs nothing.
"""
