"""laqbench: the benchmark of the PyTorch/CUDA port (``repro_torch``).

``python laqbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints
one JSON result line last.  Everything a cell needs is data found by name:
``workloads/<cell>.json`` names a configuration and a traffic mix,
``configs/<config>.json`` the data generator (``gen/<generator>.py``) and
its sizes, ``traffic/<traffic>.json`` the loop (``loops/<loop>.py``) and
its queries (``queries/<query>.json``), and each metric is read by
``metrics/<metric>.py``.  The plain reference (``reference/``), the data
generators, the peaks and the comparison that decides ``correct`` live
here too, apart from the program.
"""
