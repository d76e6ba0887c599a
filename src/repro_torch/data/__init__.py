"""The data pipeline of the port (a copy of ``repro.data``)."""
