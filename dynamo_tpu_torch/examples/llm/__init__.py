"""The canonical LLM serving graph on the port's SDK."""
