"""The device decode program and the shared fixed-point decode spec."""
