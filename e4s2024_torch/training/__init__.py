"""Generator tuning: the trainable mask and the PTI and stitching coaches."""
