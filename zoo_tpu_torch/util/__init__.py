"""Small helpers of the port: int8 narrowing, deadlines, retries,
circuit breaking, fault injection, heartbeats and wire-frame CRCs."""
