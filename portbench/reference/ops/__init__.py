"""The transition, the observation and placement, plain."""
