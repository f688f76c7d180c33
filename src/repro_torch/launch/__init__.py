"""Launch-time settings of the port (``tuning``: the knobs the layers
read)."""
