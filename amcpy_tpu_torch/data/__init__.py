"""Host-side data IO (``.mat`` files, GNU Radio captures)."""
