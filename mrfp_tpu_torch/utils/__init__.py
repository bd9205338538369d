"""Host-side utilities (the step watchdog)."""
