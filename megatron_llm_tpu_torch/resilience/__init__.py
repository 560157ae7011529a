"""The train step's anomaly guard."""
