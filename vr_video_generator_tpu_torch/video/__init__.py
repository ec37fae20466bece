"""Video decode, subclip encode and combine (host side)."""
