"""Models of the port (``repro/models``); so far xDeepFM scoring."""
