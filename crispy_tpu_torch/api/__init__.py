"""Host-side API plumbing of the port: the in-process event bus."""
