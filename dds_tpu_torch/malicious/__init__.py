"""Fault injection: Trudy's crash and byzantine attacks and Nemesis's
network attacks (`trudy.py`)."""
