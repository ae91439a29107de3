"""Host-side utilities of the port: the user-data layout and stage timers."""
