"""Plain references: plain PyTorch and NumPy, written from the
published descriptions (cselab/smarties' learners, MemoryProcessing's
Retrace, the apps' dynamics). Nothing here imports the program under
test or JAX; reference/<config>.py is the reference of one
configuration."""
