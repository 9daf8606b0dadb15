"""The metrics registry the HTTP front and engine gauges render into."""
