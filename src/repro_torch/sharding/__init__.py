"""Parameter schemas (``policy``): shapes, logical axes and init recipes."""
