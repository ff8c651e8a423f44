"""Train / eval step builders (one device)."""
