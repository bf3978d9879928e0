"""Programs that run the port's whole product loop on synthetic data."""
