"""Example payloads for the port's operator (``pi.yaml`` runs ``pi.py``)."""
