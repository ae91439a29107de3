"""Models of the port: the Whisper family and the model catalog."""
