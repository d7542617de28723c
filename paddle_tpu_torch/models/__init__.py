"""Model zoo: the transformer served by serving.py."""
