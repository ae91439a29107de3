"""Engine layer of the port: batched file and array denoising, file transcription."""
