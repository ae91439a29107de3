"""Host-side I/O for the port: the WAV codec."""
