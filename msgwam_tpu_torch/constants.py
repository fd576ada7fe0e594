"""Physical constants.

Mirrors the reference's module constants (``lib/libprop.py:3-4``) as a frozen
constants module rather than mutable module globals.
"""

RAD_EARTH: float = 6378e3  # mean Earth radius [m]
ROT_EARTH: float = 7.2921e-5  # Earth rotation rate [1/s]
