"""The benchmark of ``fdeflate_tpu_torch`` on one NVIDIA GPU.

``python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of the repository's ``BENCHMARK.json`` and
prints one JSON line of results last.  Everything a cell needs is found
by name: its configuration (``configs/<config>.json``, which names its
driver, ``drivers/<driver>.py``), its traffic mix
(``traffic/<traffic>.json``) and each per-layer metric's reader
(``metrics/<metric>.py``).  The reference that decides ``correct``
(``reference.py``) imports nothing of the program.
"""
