"""Core of the port: graph results, metrics, oracle and the device ring."""
