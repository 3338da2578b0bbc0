"""One module a traffic kind (``kind`` in a traffic file)."""
