"""The benchmark of smarties_tpu_torch, the PyTorch and CUDA port.

    python -m benchmark --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of BENCHMARK.json once on the CUDA card(s) of this machine
and prints one JSON line (the last line of standard output). Everything
is found by name: a cell names a configuration (configs/<config>.json,
with its plain reference in reference/<config>.py) and a traffic mix
(mixes/<mix>.json, which names the driver in drivers/ that runs it); a
per-layer metric is read by metrics/<metric>.py; the limits of the
numbers that decide `correct` are in limits/<cell>.json. Adding a cell,
a configuration, a mix or a metric takes new files and new entries only.

The yardstick (yardstick.py: peaks, FLOP and byte counts, spreads), the
trace reduction (trace.py) and the references are frozen here: the
program under test is imported only by the drivers.
"""
