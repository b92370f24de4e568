"""Observability for the port: the device-plane telemetry seam
(`devplane`), off-state only for now."""
