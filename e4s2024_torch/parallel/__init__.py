"""Data parallelism: a process group and DistributedDataParallel."""
