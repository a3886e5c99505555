"""Device ops: predict's input preparation, overlap-blend stitching (kernel
K1), the pre-digest and the training augmentation."""
