"""Host-side utilities: the step watchdog, host-to-device copies, the run
directory and its metric streams (JSONL and TensorBoard events), running
meters, and spans inside the program with the profiler's trace exporter."""
