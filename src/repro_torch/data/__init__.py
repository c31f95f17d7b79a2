"""Synthetic data sources of the port (``data/synthetic.py``)."""
