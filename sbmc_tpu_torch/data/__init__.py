"""Host-side ``.bin`` tile IO and datasets (numpy only)."""
