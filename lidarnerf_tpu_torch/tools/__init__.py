"""tools"""
