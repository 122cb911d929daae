from .scheduler import POLICIES, SlotScheduler

__all__ = ["POLICIES", "SlotScheduler"]
