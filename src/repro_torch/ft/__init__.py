"""Fault-tolerant training: checkpoint/restart with failure injection."""
from .driver import FailureInjector, InjectedFailure, RunReport, train_with_restarts  # noqa: F401
