"""Networks of the aligned-crop swap, with the original reference's state-dict names."""
