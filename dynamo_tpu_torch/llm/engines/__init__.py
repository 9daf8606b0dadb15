"""Test engines that need no model (the port's copy of
``dynamo_tpu/llm/engines/echo.py``)."""
