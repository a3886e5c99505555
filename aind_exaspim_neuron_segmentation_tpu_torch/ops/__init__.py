"""Device ops: overlap-blend stitching (kernel K1) and the pre-digest."""
