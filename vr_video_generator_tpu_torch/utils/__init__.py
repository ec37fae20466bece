"""Host-side helpers of the port: configuration, logging, filesystem."""
