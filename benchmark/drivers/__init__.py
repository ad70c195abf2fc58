"""Drivers of the traffic mixes: the only modules of the benchmark that
import the program under test (smarties_tpu_torch). A mix file names its
driver; the driver builds the system from the configuration, runs the
set-up, the measured window and the traced window, and hands the
compared numbers to the harness."""
