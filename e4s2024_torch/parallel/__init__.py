"""Data parallelism over a process group (`ddp.py`)."""
