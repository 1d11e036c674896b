"""Tests; a regular package so that `tests.helpers` resolves to this
directory even where another distribution installs a top-level `tests`."""
