"""Engines behind the front that are not the serving engine itself: the
echo engines that need no model (``echo.py``), a user's engine from a
Python file (``python_file.py``) and the supervised child process that
hosts either one or the torch engine (``subprocess_host.py``)."""
