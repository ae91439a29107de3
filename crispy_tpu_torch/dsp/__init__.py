"""DSP layer of the port: the RNNoise pipeline, the log-mel frontend and the resampler."""
