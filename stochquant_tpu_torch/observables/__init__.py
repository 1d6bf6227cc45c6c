"""Observables computed from a run's state."""
