"""Fault injection: Trudy's crash and byzantine attacks (`trudy.py`)."""
