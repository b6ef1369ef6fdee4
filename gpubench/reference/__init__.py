"""The plain reference the benchmark holds the program to: the batches
worked out from the raw corpus (``data``), the fine-tuning step in plain
PyTorch (``model``) and its readings (``run``).  Nothing here imports the
program under test."""
