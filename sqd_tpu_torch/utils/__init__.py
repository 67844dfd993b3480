# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Small helpers of the port."""
