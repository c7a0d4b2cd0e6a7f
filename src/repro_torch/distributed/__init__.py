"""Distributed-runtime helpers of the port. Only the watchdogs so far
(``watchdog.HangWatchdog``, ``watchdog.StragglerMonitor``), which the
serving front end arms around its blocking device reads."""
from .watchdog import HangWatchdog, StragglerMonitor

__all__ = ["HangWatchdog", "StragglerMonitor"]
