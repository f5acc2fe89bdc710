"""End-to-end apps: the detection stage, the video scans, the v1 apps
and the output oracle."""
