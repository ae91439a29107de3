"""DSP layer of the port: the RNNoise pipeline and the host resampler."""
