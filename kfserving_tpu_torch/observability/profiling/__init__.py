"""Device-path telemetry of the port: the roofline gauges."""
