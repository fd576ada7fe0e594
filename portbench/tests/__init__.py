"""The benchmark's own tests: ``python -m pytest portbench/tests`` from the
checkout's root (the ``cuda`` ones skip without a card)."""
