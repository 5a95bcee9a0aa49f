"""The benchmark's plain reference of the path tracer (imports nothing of the program)."""
