"""utils"""
