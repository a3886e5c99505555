"""Device ops: overlap-blend stitching (kernel K1), the pre-digest and the
training augmentation."""
