"""Networks of the port, with the original reference's state-dict names."""
