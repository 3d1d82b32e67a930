"""Seeded payloads and pinned vectors shared by chip_smoke.py and the tests."""
