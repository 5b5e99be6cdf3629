"""Box lower-bound kernel (iSAX MINDIST and DSTree EAPCA bound)."""
