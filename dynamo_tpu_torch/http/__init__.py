"""The OpenAI-compatible HTTP front on asyncio streams."""
