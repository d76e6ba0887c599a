"""Runtime fault tolerance of the port: heartbeats, the straggler detector
and the restart-on-failure supervisor (a copy of ``repro.runtime``)."""
